"""The port's gates: the kernel-geometry gate over the launch plans of
every hand-written kernel and the lifecycle checker over the serving
state machine (port of the kernel and lifecycle parts of
``paddle_tpu/analysis``).

- :mod:`.rules`: the frozen ``Finding`` schema and its fingerprint;
- :mod:`.auditor`: ``AuditReport``, the findings document and the
  baseline diff;
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
on the CPU: the wrappers are called over meta tensors, and the lifecycle
checker drives host bookkeeping only.
"""
from .auditor import (AuditReport, diff_findings,  # noqa: F401
                      findings_to_json, load_baseline, write_baseline)
from .kernel_rules import (KERNEL_RULE_CODES, bound,  # noqa: F401
                           check_launch, modeled_launch_bytes)
from .rules import Finding  # noqa: F401

__all__ = ["AuditReport", "Finding", "KERNEL_RULE_CODES", "bound",
           "check_launch", "diff_findings", "findings_to_json",
           "load_baseline", "modeled_launch_bytes", "write_baseline"]
