"""The RMSNorm backward at the models' real widths, on the CPU.

Formula: the port's plain backward (``kernels/ref.py:rmsnorm_bwd_ref``)
and its autograd Functions (``rmsnorm`` and the qk pair ``rmsnorm_pair``,
whose CPU backward is that plain version; the pair's backward one call of
``rmsnorm_pair_bwd``) against ``jax.vjp`` of the reference's oracle
(``repro.kernels.ref.rmsnorm_ref``), of ``repro.models.layers.
rms_norm_simple`` and of ``apply_norm`` with an rmsnorm config, at widths
512 (MLA's kv_norm), 1536 (its q_norm), 5120 (qwen3-14b's and
deepseek-v2-236b's d_model) and 6144 (mixtral-8x22b's), 512 rows, f32 and
bf16, and at a ragged width of 1030. Tolerances: f32 dx and dscale within
1e-5 of their largest magnitude (sums in other orders); bf16 dx within
2^-7·max|dx| (one bf16 ulp of the largest: both sides compute in f32 and
round once), bf16 inputs' f32 dscale within 1e-5·max|dscale|.

Order: the card's one-pass kernel (``csrc/rmsnorm.cu``) sums in f32 in a
fixed order (per lane, the lanes' butterfly, the block's rows, its row
groups' tree, the cluster's ranks, the clusters' partials);
``rmsnorm_bwd_emulation.py`` repeats it in numpy. At path 5's and path
9 (c)'s row counts (512 rows of 5120, 512 and 1536; qwen3-14b's qk pair,
20480 q rows and 4096 k rows of 128) and beyond (6144, 8192 and the
reread branch at 16384; unaligned rows of 1030), over grids of several
sizes, the emulated kernel stays within the card check's tolerances of
the f64 gradient of the same inputs: bf16 dx within 2^-7·max|dx|, f32 dx
within 1e-5·max|dx|, dscale within 1e-5·max|dscale| (its measured
distance, about 2e-7 of max|dscale|, is printed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmsnorm_bwd_emulation as emu
from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.models import layers as j_layers
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as t_rmsnorm
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_pair

ROWS = 512
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(rng, rows: int, D: int, x_scale: float = 3.0):
    x = (rng.normal(size=(rows, D)) * x_scale).astype(np.float32)
    dy = rng.normal(size=(rows, D)).astype(np.float32)
    s = (1 + 0.5 * rng.normal(size=D)).astype(np.float32)
    return x, s, dy


def _close(got, want, dtype: str, what: str):
    """f32 within 1e-5·max|want|; a bf16 gradient within 2^-7·max|want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    tol = (2.0 ** -7 if dtype == "bfloat16" else 1e-5) * float(
        np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |Δ| {err:.3e} above {tol:.3e}"


def _np(t: torch.Tensor):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [512, 1536, 5120, 6144, 1030])
def test_rmsnorm_bwd_formula_matches_jax_at_real_widths(D, dtype):
    """rmsnorm_bwd_ref and the RMSNorm Function's backward against jax.vjp
    of the reference's three RMSNorm forms, 512 rows of width D."""
    tdt, jdt = DTYPES[dtype]
    x, s, dy = _inputs(np.random.default_rng(D), ROWS, D)
    tx, tdy = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)
    ts = torch.from_numpy(s)
    plain = ref.rmsnorm_bwd_ref(tx, ts, tdy)
    xa, sa = tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)
    fn = torch.autograd.grad(rmsnorm(xa, sa), (xa, sa), tdy)
    jx, jdy = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    cfg = j_get_config("qwen3-14b", smoke=True)
    assert cfg.norm_type == "rmsnorm"
    oracles = {
        "rmsnorm_ref": jref.rmsnorm_ref,
        "rms_norm_simple": j_layers.rms_norm_simple,
        "apply_norm": lambda xx, ss: j_layers.apply_norm(cfg, {"scale": ss},
                                                         xx)}
    for name, oracle in oracles.items():
        _, vjp = jax.vjp(oracle, jx, jnp.asarray(s))
        wx, ws = vjp(jdy)
        assert wx.dtype == jdt
        wx, ws = np.asarray(wx.astype(jnp.float32)), np.asarray(ws)
        for label, (gx, gs) in (("plain", plain), ("Function", fn)):
            assert gx.dtype == tdt and gs.dtype == torch.float32
            _close(_np(gx), wx, dtype, f"{label} dx vs {name}")
            _close(_np(gs), ws, "float32", f"{label} dscale vs {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_pair_backward_is_one_call_and_matches_jax(dtype,
                                                           monkeypatch):
    """The qk pair's autograd backward at qwen3-14b's rows (512 tokens, 40
    q heads and 8 kv heads of 128) is one rmsnorm_pair_bwd call, equal to
    jax.vjp of rms_norm_simple on q and on k, each with its own scale."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    xq, sq, dyq = _inputs(rng, ROWS * 40, 128)
    xk, sk, dyk = _inputs(rng, ROWS * 8, 128, x_scale=2.0)
    calls = []
    real = t_rmsnorm.rmsnorm_pair_bwd

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(t_rmsnorm, "rmsnorm_pair_bwd", counted)
    leaves = [torch.from_numpy(a).to(t) for a, t in
              ((xq, tdt), (sq, torch.float32), (xk, tdt),
               (sk, torch.float32))]
    leaves = [a.requires_grad_(True) for a in leaves]
    yq, yk = rmsnorm_pair(*leaves)
    got = torch.autograd.grad((yq, yk), leaves, (
        torch.from_numpy(dyq).to(tdt), torch.from_numpy(dyk).to(tdt)))
    assert len(calls) == 1
    want = []
    for x, s, dy in ((xq, sq, dyq), (xk, sk, dyk)):
        _, vjp = jax.vjp(j_layers.rms_norm_simple,
                         jnp.asarray(x).astype(jdt), jnp.asarray(s))
        wx, ws = vjp(jnp.asarray(dy).astype(jdt))
        want += [np.asarray(wx.astype(jnp.float32)), np.asarray(ws)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(_np(g), w, dtype if i % 2 == 0 else "float32", f"leaf {i}")


# (name, [(rows, D)] one tensor or the pair, bf16, aligned)
ORDER_CASES = [
    ("qwen3 block norm", [(512, 5120)], True, True),
    ("qwen3 block norm f32", [(512, 5120)], False, True),
    ("MLA kv_norm", [(512, 512)], True, True),
    ("MLA kv_norm f32", [(512, 512)], False, True),
    ("a single 1024", [(64, 1024)], True, True),
    ("MLA q_norm", [(512, 1536)], True, True),
    ("qwen3 qk pair", [(20480, 128), (4096, 128)], True, True),
    ("qwen3 qk pair f32", [(20480, 128), (4096, 128)], False, True),
    ("mixtral block norm", [(512, 6144)], True, True),
    ("8192 columns", [(96, 8192)], True, True),
    ("reread branch 16384", [(40, 16384)], True, True),
    ("ragged 1030, one element a pack", [(77, 1030)], False, False),
    ("ragged pair 100", [(333, 100), (41, 100)], True, False),
    ("ragged pair 1000", [(100, 1000), (3, 1000)], False, False),
    ("f32 pair 1024", [(64, 1024), (16, 1024)], False, True),
    ("1,4096,5120", [(4096, 5120)], True, True),
]


@pytest.mark.parametrize("clusters", [8, 33, 66])
@pytest.mark.parametrize("case", ORDER_CASES, ids=[c[0] for c in
                                                   ORDER_CASES])
def test_kernel_summation_order_within_tolerance(case, clusters):
    """The kernel's f32 order (emulated) against the f64 gradient of the
    same inputs, at grids of 8, 33 and 66 clusters (at most: a small input
    takes fewer; the card takes as many as it holds)."""
    name, shapes, bf16, aligned = case
    rng = np.random.default_rng(sum(r for r, _ in shapes))
    tensors = []
    for i, (rows, D) in enumerate(shapes):
        x, s, dy = _inputs(rng, rows, D, x_scale=3.0 - i)
        if bf16:
            x, dy = emu.to_bf16(x), emu.to_bf16(dy)
        tensors.append((x, s, dy))
    D = shapes[0][1]
    plan = emu.plan(sum(r for r, _ in shapes), D, 2 if bf16 else 4,
                    vec=aligned, pair=len(shapes) == 2, clusters=clusters)
    assert plan["V"] == (1 if not aligned else 8 if bf16 else 4)
    got = emu.emulate(tensors, **plan)
    for (x, s, dy), (dx, ds) in zip(tensors, got):
        wx, ws = emu.exact(x, s, dy)
        dx = emu.to_bf16(dx) if bf16 else dx
        _close(dx, wx, "bfloat16" if bf16 else "float32", f"{name} dx")
        _close(ds, ws, "float32", f"{name} dscale")
        print(f"{name} {plan}: dscale max|Δ| / max|dscale| "
              f"{np.abs(ds - ws).max() / np.abs(ws).max():.2e}")


def test_emulation_is_the_plain_arithmetic_in_the_kernels_order():
    """On a small f32 input (24 rows of 1536: 24 blocks of one row) the
    emulated kernel and the plain backward differ only by summation order,
    within 1e-6 of each gradient's largest magnitude."""
    rng = np.random.default_rng(1)
    x, s, dy = _inputs(rng, 24, 1536)
    plan = emu.plan(24, 1536, 4, clusters=3)
    (dx, ds), = emu.emulate([(x, s, dy)], **plan)
    wx, ws = ref.rmsnorm_bwd_ref(*(torch.from_numpy(a) for a in (x, s, dy)))
    assert np.abs(dx - wx.numpy()).max() <= 1e-6 * np.abs(wx.numpy()).max()
    assert np.abs(ds - ws.numpy()).max() <= 1e-6 * np.abs(ws.numpy()).max()
    assert plan == dict(V=4, G=256, grid=24, reread=False)
