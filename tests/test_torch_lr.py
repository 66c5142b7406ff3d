"""PyTorch/CUDA port, the learning-rate schedulers
(``paddle_tpu_torch/optimizer/lr.py``) against the JAX package's
(``paddle_tpu/optimizer/lr.py``) on the CPU.

Each of the 18 names of its ``__all__`` is built with the same arguments
in both packages and driven 40 steps (``ReduceOnPlateau`` with the same
seeded metrics); the learning rates must be equal, bit for bit: both are
the same Python float arithmetic on the host."""
import math

import numpy as np
import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

pytestmark = pytest.mark.torch_port

STEPS = 40


def _base(mod):
    """``LRScheduler`` itself, through the smallest subclass: its
    ``get_lr`` is the one method a scheduler adds."""
    class Halving(mod.LRScheduler):
        def get_lr(self):
            return self.base_lr * 0.9 ** self.last_epoch
    return Halving(0.5)


# name -> builder(module): the same arguments for both packages
CASES = {
    "LRScheduler": _base,
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.93),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(
        0.1, decay_steps=15, end_lr=1e-3, power=2.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=20), warmup_steps=8,
        start_lr=0.0, end_lr=0.1),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 30],
                                                 [0.1, 0.05, 0.01, 1e-3]),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=17, eta_min=1e-4),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.5),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [4, 11, 25],
                                                 gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 1.0 / (1 + e)),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, min_lr=1e-3),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.95),
    "OneCycleLR": lambda m: m.OneCycleLR(0.2, total_steps=30),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=6,
                                     step_size_down=4, mode="triangular2"),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=25),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=1e-3),
}

# the plateau's metrics: falling, then flat with noise (the reductions)
METRICS = np.concatenate([np.linspace(2.0, 1.0, 10),
                          1.0 + 1e-6 * np.random.RandomState(0).rand(30)])


def _sequence(sched, name):
    """The scheduler's value before each of ``STEPS`` steps."""
    out = []
    for i in range(STEPS):
        out.append(sched())
        if name == "ReduceOnPlateau":
            sched.step(float(METRICS[i]))
        else:
            sched.step()
    return out


def test_cases_cover_all():
    assert set(CASES) == set(jlr.__all__) == set(tlr.__all__)
    assert len(tlr.__all__) == 18


@pytest.mark.parametrize("name", sorted(CASES))
def test_scheduler_sequence_matches_jax(name):
    """40 steps of each scheduler: the same values as the JAX package's,
    exactly, and at least one change over the run."""
    want = _sequence(CASES[name](jlr), name)
    got = _sequence(CASES[name](tlr), name)
    assert got == want
    assert all(math.isfinite(v) for v in got) and len(set(got)) > 1


def test_state_dict_round_trip_matches_jax():
    """``state_dict`` has the JAX scheduler's keys and values; a fresh
    scheduler given it continues the sequence where the first stopped."""
    j, t = (CASES["StepDecay"](m) for m in (jlr, tlr))
    for _ in range(9):
        j.step()
        t.step()
    assert t.state_dict() == j.state_dict()
    fresh = CASES["StepDecay"](tlr)
    fresh.set_state_dict(t.state_dict())
    assert _sequence(fresh, "StepDecay") == _sequence(t, "StepDecay")


def test_plateau_takes_a_tensor_metric():
    """``ReduceOnPlateau.step`` reads a 0-d torch tensor as the JAX one
    reads its Tensor: the same reductions as from floats."""
    import torch
    a, b = (CASES["ReduceOnPlateau"](tlr) for _ in range(2))
    for i in range(STEPS):
        a.step(float(METRICS[i]))
        b.step(torch.tensor(float(METRICS[i]), dtype=torch.float64))
    assert a() == b() < 0.1
