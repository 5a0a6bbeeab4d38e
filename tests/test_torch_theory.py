"""Port parity: ``repro_torch.core.theory`` (copied whole) and
``repro_torch.models.split_dims`` against the reference's.

Tolerances: the bounds and rates within a relative 1e-12 on a small grid
of their arguments (the same float expressions, so they are equal in
practice); the parameter counts, the cut planner's choice and its scores
exactly. The reference counts from ``jax.eval_shape`` and the port from
the meta device, so neither allocates a parameter.
"""
import itertools
import math
import tracemalloc

import pytest

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.core import theory as jtheory
from repro.models import split_dims as j_split_dims
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import theory as ttheory
from repro_torch.models import split_dims as t_split_dims

ARCHS = ["olmo-1b", "paper-opt-1.3b", "qwen3-14b", "internlm2-1.8b",
         "mistral-nemo-12b"]


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
        return
    assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (a, b)


GRID = list(itertools.product((1, 4, 16), (10, 1000), (1e-3, 0.5)))


@pytest.mark.parametrize("name,call", [
    ("mu_split_bound", lambda th, tau, T, lam: th.mu_split_bound(
        2.0, 1.5, T, tau, 10_000, 90_000, 0.3, 0.2, lam)),
    ("mu_split_bound eta", lambda th, tau, T, lam: th.mu_split_bound(
        2.0, 1.5, T, tau, 10_000, 90_000, 0.3, 0.2, lam, eta=1e-4)),
    ("mu_split_rate", lambda th, tau, T, lam: th.mu_split_rate(
        2.0, 1.5, T, tau, 100_000, 0.3, 0.2 + lam)),
    ("mu_splitfed_bound", lambda th, tau, T, lam: th.mu_splitfed_bound(
        2.0, 1.5, T, tau, 8, 10_000, 90_000, 0.3, 0.2, 0.1, lam)),
    ("mu_splitfed_bound eta", lambda th, tau, T, lam: th.mu_splitfed_bound(
        2.0, 1.5, T, tau, 8, 10_000, 90_000, 0.3, 0.2, 0.1, lam,
        eta=1e-4, eta_g=2.0)),
    ("mu_splitfed_rate", lambda th, tau, T, lam: th.mu_splitfed_rate(
        2.0, 1.5, T, tau, 8, 100_000, 0.3, 0.2, 0.1 + lam)),
    ("comm_complexity", lambda th, tau, T, lam: [
        th.comm_complexity(m, 100_000, tau, 8, T, lam) for m in
        ("sfl_v1", "sfl_v2", "mu_splitfed_tau1", "mu_splitfed",
         "mu_splitfed_tau_to_d")]),
    ("rounds_to_eps", lambda th, tau, T, lam: th.rounds_to_eps(
        100_000 * T, tau, 8, lam)),
    ("optimal_dc", lambda th, tau, T, lam: th.optimal_dc(100_000 * T, tau)),
    ("optimal_tau_for_cut", lambda th, tau, T, lam: [
        th.optimal_tau_for_cut(100_000 * T, d_c, tau_max=tau * 4)
        for d_c in (0, 1, 17, 300, 5000)]),
])
def test_theory_functions_match_reference(name, call):
    for tau, T, lam in GRID:
        got, want = call(ttheory, tau, T, lam), call(jtheory, tau, T, lam)
        if isinstance(want, list):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _close(g, w)
        else:
            _close(got, want)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_dims_match_reference(arch, smoke):
    """(d_c, d_s) for every cut, at the full published config and at
    SMOKE; the port's count allocates no parameter memory."""
    tcfg, jcfg = t_get_config(arch, smoke=smoke), j_get_config(arch,
                                                               smoke=smoke)
    t_split_dims(tcfg, 1)               # warm the meta-device ops
    tracemalloc.start()
    try:
        got = [t_split_dims(tcfg, c) for c in range(1, tcfg.n_units + 1)]
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    want = [j_split_dims(jcfg, c) for c in range(1, jcfg.n_units + 1)]
    assert got == want
    assert peak < 64 * 2 ** 20


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_cut_matches_reference(arch):
    for smoke, tau in ((True, 1), (True, 16), (False, 4), (False, 64)):
        got = ttheory.plan_cut(t_get_config(arch, smoke=smoke), tau)
        want = jtheory.plan_cut(j_get_config(arch, smoke=smoke), tau)
        assert got[0] == want[0]
        assert got[1] == want[1]
