"""The port's gates: the static program audit over fake-tensor traces
of the port's programs, the kernel-geometry gate over the launch plans of
every hand-written kernel and the lifecycle checker over the serving
state machine (port of ``paddle_tpu/analysis``).

- :mod:`.registry`: ``ProgramSpec`` (a callable, its abstract signature
  of ``TensorStruct`` leaves and the rules' metadata), ``ProgramRegistry``
  and the shared ``REGISTRY``;
- :mod:`.rules`: the frozen ``Finding`` schema and the five program rules
  over a traced ``torch.fx`` graph (dtype promotion, in-place
  declarations, recapture hazards, collective axes, constant bloat);
- :mod:`.auditor`: the fake-tensor trace, ``audit_spec``/
  ``audit_program``/``audit_registry``, ``AuditReport``, the findings
  document, the baseline diff and ``publish_findings``;
- :mod:`.catalog`: the programs the gate audits, at tiny sizes, and the
  two regression specimens; :mod:`.program_audit`, its CLI, ``python -m
  paddle_tpu_torch.analysis.program_audit``;
- :mod:`.kernel_rules`: the geometry rules over a captured
  ``KernelLaunchSpec`` (GRID_FLOOR_DROP, OOB_BLOCK, WRITE_RACE,
  SMEM_OVERCOMMIT, ARG_MISMATCH) and the byte and bound model of a launch;
- :mod:`.kernel_catalog`: the tiny and flagship cases of every launch, the
  FLOP model and the regression specimen ``demo_prefix_mlp_block``;
- :mod:`.kernel_audit`: the CLI, ``python -m
  paddle_tpu_torch.analysis.kernel_audit``;
- :mod:`.lifecycle`: the lifecycle model checker over the serving host
  classes (``BlockManager``, ``PrefixCache``, ``AdmissionQueue``), and
  :mod:`.lifecycle_audit`, its CLI, ``python -m
  paddle_tpu_torch.analysis.lifecycle_audit``.

It imports ``torch`` and numpy, never ``jax`` or ``paddle_tpu``, and runs
on the CPU: programs are traced over fake tensors, the wrappers are called
over meta tensors, and the lifecycle checker drives host bookkeeping only.
"""
from .auditor import (AuditReport, audit_program,  # noqa: F401
                      audit_registry, audit_spec, diff_findings,
                      findings_to_json, load_baseline, publish_findings,
                      trace_artifacts, write_baseline)
from .kernel_rules import (KERNEL_RULE_CODES, bound,  # noqa: F401
                           check_launch, modeled_launch_bytes)
from .registry import (REGISTRY, ProgramRegistry,  # noqa: F401
                       ProgramSpec, TensorStruct, abstract_signature,
                       register_program)
from .rules import (ALL_RULES, DROPPED_CODES, Finding,  # noqa: F401
                    RULE_CODES, collective_consistency_rule,
                    constant_bloat_rule, donation_rule,
                    dtype_promotion_rule, retrace_hazard_rule)

__all__ = ["AuditReport", "Finding", "ProgramRegistry", "ProgramSpec",
           "REGISTRY", "ALL_RULES", "DROPPED_CODES", "RULE_CODES",
           "KERNEL_RULE_CODES", "TensorStruct", "abstract_signature",
           "audit_program", "audit_registry", "audit_spec", "bound",
           "check_launch", "collective_consistency_rule",
           "constant_bloat_rule", "diff_findings", "donation_rule",
           "dtype_promotion_rule", "findings_to_json", "load_baseline",
           "modeled_launch_bytes", "publish_findings",
           "register_program", "retrace_hazard_rule", "trace_artifacts",
           "write_baseline"]
