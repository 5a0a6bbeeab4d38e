"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips elsewhere. The file imports
neither jax nor the JAX package, so on a machine with a card and no jax it
runs on its own:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances as in test_torch_kernels.py: f32 within 1e-5 (1e-4 for a
300-record replay, whose sum runs with fused multiply-adds on the card),
bf16 within one bf16 ulp of the plain value. RMSNorm in f32 within 1e-5
(|y| <= ~20 here; the sums of squares run in another order). The
threefry kernel computes the plain version's operations in its order, so
its bits, its gaussian and its updates equal the plain version's exactly;
its sum of squares runs in another order (relative 1e-5). Small f32
vanilla and GAS rounds, card against CPU, within 1e-4.

Backward kernels (flash_attention_bwd, rmsnorm_bwd) against their plain
versions on the same inputs: f32 within 1e-5 of each gradient's largest
magnitude (sums run in another order), bf16 within one bf16 ulp of it
(2^-7·max|g|: both sum in f32 and round once; the bf16 flash backward
also rounds P and dS to enter the tensor cores, which
tests/test_torch_flash_bwd.py emulates on the CPU); the forward's lse
within 1e-5 relative. Two bf16 flash backward launches are bit-equal. Small f32 FedAvg (SGD, AdamW) and FedLoRA rounds,
card against CPU, within 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref, threefry, zo_update
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd, rmsnorm_pair

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


def assert_close(got, want, tol=1e-5):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        assert bool((d <= 2.0 ** -7 * want.float().abs() + 1e-5).all())
    else:
        assert float(d.max()) <= tol


def _leaf(case, dtype, device):
    """The parity leaves of the noise kernels: 'ragged' (5000, 37); an
    'aligned' (8192, 1024), whole 16-byte groups; 'misaligned', a view at
    an odd element offset into its buffer (no 16-byte accesses) whose size
    is no multiple of 8."""
    gen = torch.Generator(device=device).manual_seed(11)
    if case == "ragged":
        return torch.randn(5000, 37, generator=gen, device=device).to(dtype)
    if case == "aligned":
        return torch.randn(8192, 1024, generator=gen, device=device).to(dtype)
    return torch.randn(100004, generator=gen, device=device).to(dtype)[1:]


@pytest.mark.parametrize("case", ["ragged", "aligned", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zo_kernels_match_plain(cuda, dtype, case):
    """Each leaf at a row offset; 300 records, past one shared-memory tile
    of records. The noise alone (x = 0, coefficient 1) equals the plain
    version's bit for bit."""
    x = _leaf(case, dtype, cuda)
    rng = np.random.default_rng(9)
    seeds = rng.integers(0, 2 ** 32, size=300, dtype=np.uint32)
    c = torch.from_numpy((rng.normal(size=300) * 0.1).astype(np.float32)
                         ).to(cuda)
    before = dict(build.LAUNCHES)
    got_u = ops.zo_update_leaf(x, 1234, c[:1], row_offset=5)
    got_r = ops.zo_replay_leaf(x, seeds, c, row_offset=5)
    torch.cuda.synchronize()
    assert build.LAUNCHES["zo_update"] == before.get("zo_update", 0) + 1
    assert build.LAUNCHES["zo_replay"] == before.get("zo_replay", 0) + 1
    assert_close(got_u, ref.zo_update_ref(x, 1234, c[:1], 5))
    assert_close(got_r, ref.zo_replay_ref(x, seeds, c, 5), tol=1e-4)
    z = torch.zeros_like(x)
    one = torch.ones(1, device=cuda)
    assert torch.equal(ops.zo_update_leaf(z, 77, one, row_offset=5),
                       ref.zo_update_ref(z, 77, one, 5))


@pytest.mark.parametrize("reference", ["libdevice", "plain"])
def test_zo_noise_bit_equal_over_all_hash_values(cuda, reference):
    """The kernels' radial factor sqrtf(-2·logf(u1)) and angular factor
    cosf(2π·u2), specialised to their domain, equal bit for bit at every
    one of the 2^32 hash values libdevice's precise functions compiled
    beside them, and the plain version's torch ops; u is their one rounded
    product, so u is bit-equal too."""
    assert zo_update.noise_exhaustive_check(cuda, reference) == {
        "radial": (0, None), "angular": (0, None)}
    with pytest.raises(ValueError, match="CUDA device"):
        zo_update.noise_exhaustive_check("cpu")


@pytest.mark.parametrize("case", [(2, 8, 8, 200, 64, True, 0),
                                  (1, 8, 2, 256, 128, True, 100),
                                  (1, 4, 4, 192, 128, False, 70),
                                  (1, 10, 2, 512, 128, True, 0),
                                  (2, 4, 4, 500, 64, False, 70),
                                  (1, 5, 1, 300, 128, True, 30)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, case, dtype):
    """d 64 and 128, ragged S (200, 300, 500), causal and not, windows,
    GQA groups 4 and 5 (qwen3-14b's). Strided views, as the model passes
    them: v as the transpose of a (B, S, Hkv, d) tensor gives the
    contiguous call's result bit for bit, and o comes back as a view of a
    (B, S, H, d) buffer."""
    B, H, Hkv, S, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(S + d + H)
    q = torch.randn(B, H, S, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, Hkv, S, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, d, generator=gen, device=cuda).to(
        dtype).transpose(1, 2)
    got = flash_attention(q, k, v.contiguous(), causal=causal, window=window)
    before = build.LAUNCHES["flash_attention"]
    strided = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == before + 1
    assert strided.transpose(1, 2).is_contiguous()
    assert torch.equal(strided, got)
    assert_close(got, ref.flash_attention_ref(q, k, v, causal, window))


@pytest.mark.parametrize("shape", [(1, 512, 5120), (1, 512, 40, 128),
                                   (1, 512, 8, 128), (3, 7, 128),
                                   (1, 300, 5120), (333, 100), (77, 1030)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches_plain(cuda, shape, dtype):
    """The qwen3-14b path's block-norm and qk-norm shapes, a row count
    that is no multiple of the 8 rows of a warp-per-row block (21), and
    widths with no 16-byte loads (100, 1030)."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen, device=cuda) * 3.0).to(dtype)
    s = 1.0 + 0.5 * torch.randn(shape[-1], generator=gen, device=cuda)
    before = build.LAUNCHES["rmsnorm"]
    got = rmsnorm(x, s)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rmsnorm"] == before + 1
    assert_close(got, ref.rmsnorm_ref(x, s))


@pytest.mark.parametrize("case", ["ragged", "aligned", "misaligned",
                                  "short run", "across 2^32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threefry_kernels_match_plain(cuda, dtype, case):
    """At an element offset into the leaf: the cipher's bits and the
    gaussian equal the plain version's; the update (gaussian, and the
    sphere's scaled form) equals it bit for bit; the sum of squares is
    within 1e-5 relative of a float64 sum and the same on a second run.
    'short run': an aligned (999, 37) leaf, whose last thread's run of 8
    is cut short; 'across 2^32': the ragged leaf at offset 2^32 - 1000, so
    the counter's high word changes inside the leaf."""
    if case == "short run":
        gen = torch.Generator(device=cuda).manual_seed(13)
        x = torch.randn(999, 37, generator=gen, device=cuda).to(dtype)
    else:
        x = _leaf("ragged" if case == "across 2^32" else case, dtype, cuda)
    key = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    n, off = x.numel(), (2 ** 32 - 1000 if case == "across 2^32" else 5)
    before = build.LAUNCHES["threefry"]
    bits, z = threefry.threefry_noise(n, key, cuda, offset=off)
    assert torch.equal(bits, ref.threefry_bits_ref(key, n, off, cuda))
    assert torch.equal(z, ref.threefry_normal_ref(key, n, off, cuda))
    c = torch.full((1,), 0.37, device=cuda)
    s = torch.full((1,), 1.0625, device=cuda)
    for scale in (None, s):
        got = threefry.threefry_update(x, key, c, scale=scale, offset=off)
        assert torch.equal(got, ref.threefry_update_ref(x, key, c, scale,
                                                        off))
    sums = []
    for _ in range(2):
        acc = torch.full((1,), 0.5, device=cuda)
        sums.append(float(threefry.threefry_sumsq(n, key, acc, offset=off)))
    want = 0.5 + float((z.double() ** 2).sum())
    assert abs(sums[0] - want) <= 1e-5 * want and sums[0] == sums[1]
    torch.cuda.synchronize()
    assert build.LAUNCHES["threefry"] == before + 5


def test_threefry_gaussian_bit_equal_over_all_uniforms(cuda):
    """The kernel's float part for each of the 2^23 values of bits >> 9
    against the plain version's torch ops on the card."""
    check = threefry.normal_table_check(cuda)
    assert check["mismatches"] == 0, check


@pytest.mark.parametrize("shapes", [((1, 512, 40, 128), (1, 512, 8, 128)),
                                    ((3, 7, 2, 128), (3, 7, 1, 128)),
                                    ((5, 64), (2, 64)), ((9, 100), (4, 100))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_pair_matches_plain(cuda, shapes, dtype):
    """The qwen3-14b qk-norm shapes, ragged row counts (21 + 7 rows), a
    bf16 row of 64 (half a half-warp) and a width with no 16-byte loads:
    one launch, equal to two single-tensor launches bit for bit (the same
    sums: the lanes the pair kernel drops held zeros), and to the plain
    pair within the single kernel's tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(len(shapes[0]))
    xq, xk = [(torch.randn(sh, generator=gen, device=cuda) * 3.0).to(dtype)
              for sh in shapes]
    D = shapes[0][-1]
    sq, sk = [1.0 + 0.5 * torch.randn(D, generator=gen, device=cuda)
              for _ in range(2)]
    before = build.LAUNCHES["rmsnorm"]
    yq, yk = rmsnorm_pair(xq, sq, xk, sk)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rmsnorm"] == before + 1
    assert torch.equal(yq, rmsnorm(xq, sq))
    assert torch.equal(yk, rmsnorm(xk, sk))
    wq, wk = ref.rmsnorm_pair_ref(xq, sq, xk, sk)
    assert_close(yq, wq)
    assert_close(yk, wk)


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.randn(1, 2, 64, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        ops.zo_update_leaf(torch.zeros(8, device=cuda, dtype=torch.float16),
                           1, 0.1)
    x = torch.randn(4, 256, device=cuda)
    s = torch.ones(256, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(x[:, ::2], s[:128])
    with pytest.raises(ValueError, match="scale"):
        rmsnorm(x, s[:128])
    with pytest.raises(ValueError, match="scale"):
        rmsnorm(x, s.to(torch.bfloat16))
    with pytest.raises(ValueError, match="row width"):
        rmsnorm_pair(x, s, x[:, :128].contiguous(), s[:128])
    with pytest.raises(ValueError, match="one value"):
        threefry.threefry_update(x, np.zeros(2, np.uint32),
                                 torch.ones(2, device=cuda))


@pytest.mark.parametrize("algorithm,dist,aggregation", [
    ("vanilla", "gaussian", "dense"), ("vanilla", "counter", "seed_replay"),
    ("gas", "gaussian", "dense"), ("gas", "gaussian", "seed_replay"),
    ("gas", "counter", "seed_replay")])
def test_baseline_round_card_matches_cpu(cuda, algorithm, dist, aggregation):
    """One small f32 vanilla or GAS round (GAS with a stale client) on the
    card against the same round on the CPU, where the plain versions run:
    parameters, metrics and GAS's buffer within 1e-4."""
    from repro_torch.configs import SFLConfig, get_config
    from repro_torch.core import prng
    from repro_torch.core.baselines import (gas_init_state, gas_round,
                                            vanilla_splitfed_round)
    from repro_torch.models import init_params, untie_params
    from repro_torch.utils import tree
    cfg = get_config("olmo-1b", smoke=True).replace(
        d_model=128, n_heads=2, n_kv_heads=2, dtype="float32")
    params = untie_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 64))
    sfl = SFLConfig(n_clients=2, tau=2, n_perturbations=2, cut_units=2,
                    perturbation_dist=dist)
    outs = []
    for d in ("cpu", cuda):
        b = {"tokens": torch.from_numpy(toks).to(d),
             "labels": torch.from_numpy(np.roll(toks, -1, -1)).to(d)}
        p = tree.tree_map(lambda a: a.to(d), params)
        if algorithm == "gas":
            st = gas_init_state(cfg, sfl, p, b)
            p, st, m = gas_round(cfg, sfl, p, st, b,
                                 torch.tensor([1.0, 0.0], device=d),
                                 prng.PRNGKey(3), aggregation=aggregation)
            extra = [*st.h_buffer.values(), *st.label_buffer.values()]
        else:
            p, m = vanilla_splitfed_round(
                cfg, sfl, p, b, torch.tensor([1.0, 0.5], device=d),
                prng.PRNGKey(3), aggregation=aggregation)
            extra = []
        outs.append([*tree.leaves(p), *m, *extra])
    for got, want in zip(outs[1], outs[0]):
        assert got.is_cuda
        assert float((got.cpu().float() - want.float()).abs().max()) <= 1e-4


def assert_grad_close(got, want):
    """Within 1e-5 (f32) or one bf16 ulp (bf16) of max|want|."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got.float()).all())
    tol = (2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5) \
        * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


FLASH_BWD_CASES = [((1, 32, 32, 512, 64), True, 0),      # paper-opt-1.3b
                   ((1, 40, 8, 512, 128), True, 0),      # qwen3-14b, GQA 5
                   ((2, 8, 2, 500, 128), True, 128),     # ragged, window
                   ((1, 4, 4, 300, 64), False, 70),      # not causal
                   ((2, 4, 4, 40, 64), True, 0),         # S below one tile
                   ((1, 8, 2, 513, 128), True, 0),       # S one past a tile
                   ((1, 10, 2, 300, 128), True, 100)]    # GQA 5, window


@pytest.mark.parametrize("case", FLASH_BWD_CASES,
                         ids=["opt", "qwen3-gqa", "window-ragged",
                              "noncausal-window", "S40", "S513",
                              "gqa5-window"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_matches_plain(cuda, case, dtype):
    """The backward kernel on the plain forward's o and lse, and the whole
    autograd Function (the kernel forward's lse) against autograd through
    the plain forward; v and dO as strided views, as the model passes
    them."""
    (B, H, Hkv, S, d), causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(B, H, S, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, Hkv, S, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, d, generator=gen, device=cuda).to(
        dtype).transpose(1, 2)
    do = torch.randn(B, S, H, d, generator=gen, device=cuda).to(
        dtype).transpose(1, 2)
    o, lse = ref.flash_attention_ref(q, k, v, causal, window,
                                     return_lse=True)
    before = build.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention_bwd"] == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window)
    for g, w in zip(got, want):
        assert_grad_close(g, w)
    # the Function: kernel forward with its lse, then the kernel backward
    qkv = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*qkv, causal=causal, window=window)
    assert_close(out, o)
    got = torch.autograd.grad(out, qkv, do)
    qkv = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*qkv, causal, window), qkv, do)
    for g, w in zip(got, want):
        assert_grad_close(g, w)


def _bwd_inputs(device, B, H, Hkv, S, d, causal, window, seed=7):
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = torch.bfloat16
    q = torch.randn(B, H, S, d, generator=gen, device=device).to(bf16)
    k = torch.randn(B, Hkv, S, d, generator=gen, device=device).to(bf16)
    v = torch.randn(B, Hkv, S, d, generator=gen, device=device).to(bf16)
    do = torch.randn(B, H, S, d, generator=gen, device=device).to(bf16)
    o, lse = ref.flash_attention_ref(q, k, v, causal, window,
                                     return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("case", [((1, 40, 8, 512, 128), True, 0),
                                  ((1, 32, 32, 512, 64), True, 0),
                                  ((1, 10, 2, 300, 128), False, 100)],
                         ids=["qwen3-gqa", "opt", "gqa5-noncausal-window"])
def test_flash_attention_bwd_is_deterministic(cuda, case):
    """Two bf16 backward launches on the same inputs are bit-equal: no
    atomics, and the dK/dV partials of a kv group's heads are summed in a
    fixed order."""
    (B, H, Hkv, S, d), causal, window = case
    inputs = _bwd_inputs(cuda, B, H, Hkv, S, d, causal, window)
    first = flash_attention_bwd(*inputs, causal=causal, window=window)
    second = flash_attention_bwd(*inputs, causal=causal, window=window)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_bwd_copies_a_misaligned_do(cuda):
    """A bf16 dO the kernels cannot read in place (contiguous, but at an odd
    element offset into its buffer, so its rows are not on 16 bytes) is
    copied first and gives the gradient of the aligned dO."""
    from repro_torch.kernels.flash_attention import _fits
    B, H, Hkv, S, d = 1, 8, 2, 200, 128
    q, k, v, o, lse, do = _bwd_inputs(cuda, B, H, Hkv, S, d, True, 0)
    buf = torch.empty(do.numel() + 1, dtype=do.dtype, device=cuda)
    odd = buf[1:].view(do.shape)
    odd.copy_(do)
    assert odd.is_contiguous() and not _fits(odd)
    got = flash_attention_bwd(q, k, v, o, lse, odd)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert_grad_close(g, w)
    aligned = flash_attention_bwd(q, k, v, o, lse, do)
    for g, a in zip(got, aligned):
        assert torch.equal(g, a)


def test_flash_attention_lse_matches_plain(cuda):
    """The forward's row log-sum-exp (written only under autograd), bf16 and
    f32, against the plain version's."""
    from repro_torch.kernels.flash_attention import _launch_forward
    gen = torch.Generator(device=cuda).manual_seed(6)
    for dtype, d in ((torch.bfloat16, 128), (torch.float32, 64)):
        q, k, v = (torch.randn(2, 4, 200, d, generator=gen,
                               device=cuda).to(dtype) for _ in range(3))
        o = torch.empty_like(q)
        lse = torch.empty(2, 4, 200, device=cuda)
        _launch_forward(q, k, v, o, lse, True, 50)
        wo, wl = ref.flash_attention_ref(q, k, v, True, 50, return_lse=True)
        assert_close(o, wo)
        assert float(((lse - wl).abs() / wl.abs().clamp(min=1)).max()) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 512, 5120), (1, 512, 40, 128),
                                   (1, 512, 8, 128), (3, 7, 128),
                                   (1, 300, 5120), (333, 100), (77, 1030)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    D = shape[-1]
    x = (torch.randn(shape, generator=gen, device=cuda) * 3.0).to(dtype)
    dy = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    s = 1.0 + 0.5 * torch.randn(D, generator=gen, device=cuda)
    before = build.LAUNCHES["rmsnorm_bwd"]
    dx, ds = rmsnorm_bwd(x, s, dy)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rmsnorm_bwd"] == before + 1
    wx, ws = ref.rmsnorm_bwd_ref(x, s, dy)
    assert_grad_close(dx, wx)
    assert_grad_close(ds, ws)
    # through autograd: the pair (two backward launches) and the single
    xa, sa = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    got = torch.autograd.grad(rmsnorm(xa, sa), (xa, sa), dy)
    assert_grad_close(got[0], wx)
    assert_grad_close(got[1], ws)
    if D <= 1024:
        n0 = build.LAUNCHES["rmsnorm_bwd"]
        yq, yk = rmsnorm_pair(xa, sa, xa, sa)
        gq = torch.autograd.grad((yq, yk), (xa, sa), (dy, dy))
        assert build.LAUNCHES["rmsnorm_bwd"] == n0 + 2
        assert_grad_close(gq[0], (wx.float() * 2).to(dtype))
        assert_grad_close(gq[1], ws * 2)


def test_backward_kernels_raise_on_what_they_do_not_take(cuda):
    """With gradients on, what the kernels do not take raises, never falls
    back: a head dim outside (64, 128), a float16 input."""
    q = torch.randn(1, 2, 64, 32, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    h = torch.randn(1, 2, 64, 64, device=cuda, dtype=torch.float16,
                    requires_grad=True)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        flash_attention(h, h, h)
    x = torch.randn(4, 256, device=cuda, dtype=torch.float16,
                    requires_grad=True)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        rmsnorm(x, torch.ones(256, device=cuda))


# learning rates of the small first-order rounds. AdamW runs at the repo's
# own first-order default (TrainConfig.lr = 1e-3): its first step moves an
# element by lr·g/(|g| + 1e-8), which turns a gradient at f32 rounding
# level into a step of up to lr, so the same gradient evaluated in f32 and
# in f64 on the CPU gives directions up to 5e-2 apart; at lr 1e-2 the card
# and the CPU were 1.8e-4 apart after one round.
FO_LR = {"sgd": 1e-2, "adamw": 1e-3}


def fo_small_round(algorithm, optimizer, device):
    """One small f32 FedAvg or FedLoRA round (olmo-1b for FedAvg, qwen3-14b
    with qk-norm for FedLoRA, both at d_head 64) on ``device``: the new
    tree's leaves."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.baselines import fedavg_round, fedlora_round
    from repro_torch.models import init_params, untie_params
    from repro_torch.optim import init_lora
    from repro_torch.utils import tree
    arch = "olmo-1b" if algorithm == "fedavg" else "qwen3-14b"
    cfg = get_config(arch, smoke=True).replace(
        d_model=128, n_heads=2, n_kv_heads=2 if arch == "olmo-1b" else 1,
        dtype="float32")
    params = untie_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0)))
    params = tree.tree_map(lambda a: a.to(device), params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 64))
    b = {"tokens": torch.from_numpy(toks).to(device),
         "labels": torch.from_numpy(np.roll(toks, -1, -1)).to(device)}
    mask = torch.tensor([1.0, 0.5], device=device)
    if algorithm == "fedavg":
        out = fedavg_round(cfg, params, b, mask, FO_LR[optimizer],
                           optimizer=optimizer, eta_g=0.3)
    else:
        lora = init_lora(cfg, params, 4, prng.PRNGKey(0))
        out = fedlora_round(cfg, params, lora, b, mask, FO_LR["sgd"],
                            eta_g=0.3)
    return tree.leaves(out)


@pytest.mark.parametrize("algorithm,optimizer", [
    ("fedavg", "sgd"), ("fedavg", "adamw"), ("fedlora", "sgd")])
def test_fo_round_card_matches_cpu(cuda, algorithm, optimizer):
    """One small f32 first-order round on the card (the forward and
    backward kernels) against the same round on the CPU (their plain
    versions): the new tree within 1e-4."""
    before = dict(build.LAUNCHES)
    got = fo_small_round(algorithm, optimizer, cuda)
    for k in ("flash_attention_bwd",) + (("rmsnorm_bwd",)
                                         if algorithm == "fedlora" else ()):
        assert build.LAUNCHES[k] > before.get(k, 0)
    want = fo_small_round(algorithm, optimizer, torch.device("cpu"))
    for g, w in zip(got, want):
        assert g.is_cuda
        assert float((g.cpu() - w).abs().max()) <= 1e-4


def test_bf16_logits_product_gradient(cuda):
    """The card's bf16 head product into f32 logits (``_LogitsF32``, the
    loss's chunked cross-entropy on bf16 models) under autograd: logits
    and both gradients against f32 autograd of the same product, within
    2^-6 of each one's largest magnitude (the incoming gradient and each
    gradient are rounded to bf16 once)."""
    from repro_torch.models.transformer import _logits_f32
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(2, 96, 256, generator=gen, device=cuda).to(
        torch.bfloat16).requires_grad_(True)
    head = (torch.randn(256, 1000, generator=gen, device=cuda) / 16).to(
        torch.bfloat16).requires_grad_(True)
    g = torch.randn(2, 96, 1000, generator=gen, device=cuda)
    out = _logits_f32(x, head)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, (x, head), g)
    xf, hf = (t.detach().float().requires_grad_(True) for t in (x, head))
    want_out = xf @ hf
    want = torch.autograd.grad(want_out, (xf, hf), g)
    assert float((out - want_out).abs().max()) <= 1e-3 * float(
        want_out.abs().max())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b).abs().max()) <= 2.0 ** -6 * float(
            b.abs().max())
