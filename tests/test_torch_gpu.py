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
card against CPU, within 1e-4. The MoE block (mixtral-8x22b SMOKE, f32)
card against CPU: routing equal, the output within 1e-5 of its largest
magnitude; SMOKE serving in f32 (deepseek-v2-236b's MLA at the flash
kernel's (192, 128) pair among them): tokens equal, logits within 1e-4.
MLA's flash pair (192, 128) f32 and bf16 against the plain version, v
read in place as the model's strided view, forward and backward (G = 1
and G = 2, v and dO strided views), and a small f32 FedAvg round of
deepseek-v2-236b widened to that pair, card against CPU within 1e-4. The
bf16 backward kernels against their CPU emulation
(tests/flash_bwd_emulation.py) on the input that chose dQ's dS split
(seed 3790) and on a (192, 128) case: each gradient's largest difference
within 2^-7·max|g|, and the kernels' own margin to the plain version
within the emulation's by 0.25 of that tolerance. The rmsnorm backward
(one launch, the qk pair's q and k in one grid) at widths up to 16384
(past 8192 the branch that rereads rows), two calls bit-equal at every
shape, single and pair; past the old 4.19 M-row limit (rows of 128,
bf16); and against its CPU emulation (tests/rmsnorm_bwd_emulation.py) at
the geometry the launch reports: dscale within 2^-20·max|dscale|, dx
within 2^-8·max|dx|.

The selective scan (Mamba) against its plain version at N 4 and 16, S 1,
33, 40, 65 and 512, zero and nonzero h0 and a ragged d_in: f32 y and
h_last within 1e-5 of each largest magnitude (both run the tokens in
order; the kernel contracts multiply-adds and sums over n in lane groups,
tests/test_torch_scan_order.py); bf16 y within two bf16 ulps of each
element plus 1e-5 of max|y| (y is rounded twice, before and after the
silu(z) gate, so an f32 difference that moves the first rounding moves
the product by up to two ulps), h_last as in f32. Two launches are
bit-equal, an h_out that is h0 itself gives the same results, and z, B
and C read in place as strided views equal contiguous copies. jamba
SMOKE serving, card against CPU, as the other archs. The scan's backward
kernel against ref.selective_scan_bwd_ref at N 4 and 16, S 1, 31, 32,
33 and 300, B 2, a ragged d_in, nonzero h0 and dh_last, z, B and C as
strided views, and where its geometry has edges (grids of 3 and 9
blocks rounded up to whole clusters, B 3, S 38, 33 and 4097, an odd d_in
copied element by element): each gradient within 1e-5 (f32) or 2^-7
(bf16) of its largest magnitude; two calls bit-equal; the forward that
saves chunk starts equal to the one that does not, its chunk starts
equal to h_last of the sequence's heads; the autograd path on the card
against the CPU's within the same; small f32 FedAvg and FedLoRA rounds
of jamba SMOKE, card against CPU, within 1e-4.

The sLSTM recurrence (xLSTM) against its plain version ref.slstm_ref at
head dims 16, 32, 64 and 256 (one block a head, and clusters of dh / 16
blocks a head and group of batch rows), S 1 to 512, B from 1 to several
groups of batch rows with a ragged last one, from the initial and from a
nonzero state: f32 hs and the final
c, n, h within 1e-5 of each largest magnitude and m within 1e-5 of
max(|m|, 1) (the kernel sums the recurrent product over d in another
order); bf16 hs within two bf16 ulps of each element plus 1e-5 of
max|hs| (an f32 difference can move the rounding), the state as in f32.
Two launches are bit-equal, the state given as ``out`` (decode's
in-place state) gives the same results, and so does an x_pre that is not
16-byte aligned. Small f32 MU-SplitFed and GAS
rounds of xlstm-350m widened by card_smoke_config (sLSTM head dim 32),
card against CPU within 1e-4, and its serving, tokens equal and logits
within 1e-4. The sLSTM backward (slstm_bwd, from the saving forward's
record) against ref.slstm_bwd_ref at head dims 16 to 256, S 1, 33, 40, 65
and 512, B 1, R+1 and several groups with a ragged one, from the initial
and a nonzero state, with nonzero dhs and final-state cotangents: dx_pre
within 2^-7 (bf16) or 1e-5 (f32) of its largest magnitude, db, dr and the
initial state's cotangents within 1e-5 of theirs (the kernel sums the
transposed product over the cluster's blocks, and dr over B*S, in
another order); two launches bit-equal; the saving forward's hs and state
bit-equal to the inference forward's, its record holding the initial
state; under autograd the card against the CPU within the same; small
f32 FedAvg and FedLoRA rounds of xlstm-350m, card against CPU within
1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref, threefry, zo_update
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                        rmsnorm_bwd_plan, rmsnorm_pair,
                                        rmsnorm_pair_bwd)
from repro_torch.kernels.selective_scan import LANES, selective_scan
from repro_torch.kernels.slstm import SAVED, slstm, slstm_bwd

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
                                   (1, 300, 5120), (333, 100), (77, 1030),
                                   (1, 512, 512), (1, 512, 1536),
                                   (1, 1, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches_plain(cuda, shape, dtype):
    """The qwen3-14b path's block-norm and qk-norm shapes, a row count
    that is no multiple of the 8 rows of a warp-per-row block (21), widths
    with no 16-byte loads (100, 1030), and deepseek-v2-236b's kv_norm
    (512: 32 lanes a row with 16-byte loads, in bf16 the only case of that
    instance) and q_norm (1536: a block a row) over the round's rows and a
    decode row."""
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


@pytest.mark.parametrize("case", [(1, 8, 512, True), (2, 4, 300, True),
                                  (1, 4, 200, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_pair_matches_plain(cuda, case, dtype):
    """MLA's head dims (d_qk, d_v) = (192, 128), H = Hkv, causal and not,
    S a multiple of 64 and ragged (300, 200): against the plain version.
    v is taken as the model takes it, a strided view at element offset 128
    of each head's 256-wide row of a (B, S, H, 256) tensor (256 bytes in
    bf16, strides multiples of 8): the kernel reads it in place, with the
    contiguous call's result bit for bit, and o comes back as a (B, H, S,
    128) view of a (B, S, H, 128) buffer."""
    from repro_torch.kernels.flash_attention import _fits
    B, H, S, causal = case
    gen = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn(B, H, S, 192, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, H, S, 192, generator=gen, device=cuda).to(dtype)
    kv = torch.randn(B, S, H, 256, generator=gen, device=cuda).to(dtype)
    v = kv[..., 128:].transpose(1, 2)
    assert _fits(v)
    got = flash_attention(q, k, v.contiguous(), causal=causal)
    before = dict(build.LAUNCHES)
    strided = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    for key in ("flash_attention", "flash_attention (192, 128)"):
        assert build.LAUNCHES[key] == before.get(key, 0) + 1
    assert strided.shape == (B, H, S, 128)
    assert strided.transpose(1, 2).is_contiguous()
    assert torch.equal(strided, got)
    assert_close(got, ref.flash_attention_ref(q, k, v, causal, 0))


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


# (B, H, Hkv, S), causal: MLA's (192, 128) pair at path 9 (c)'s 128
# heads cut to 8 (G = 1), ragged and not causal, and G = 2 and 3, which
# MLA itself never has (H = Hkv) but the kernels take
MLA_BWD_CASES = [((1, 8, 8, 512), True), ((2, 4, 4, 300), False),
                 ((1, 8, 4, 200), True), ((1, 6, 2, 130), False)]


@pytest.mark.parametrize("case", MLA_BWD_CASES,
                         ids=["G1", "G1-noncausal-ragged", "G2-ragged",
                              "G3-noncausal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_mla_pair_matches_plain(cuda, case, dtype):
    """The backward at MLA's head dims (d_qk, d_v) = (192, 128), on the
    plain forward's o and lse, and the whole autograd Function, against
    the plain version. v is the model's strided view (offset 128 of each
    head's 256-wide row of a (B, S, Hkv, 256) tensor, read in place) and
    dO a (B, H, S, 128) view of a (B, S, H, 128) buffer; the launch is
    counted under the pair, and dv comes back 128 wide."""
    (B, H, Hkv, S), causal = case
    gen = torch.Generator(device=cuda).manual_seed(S + H)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)
    q, k, kv = rnd(B, H, S, 192), rnd(B, Hkv, S, 192), rnd(B, S, Hkv, 256)
    v = kv[..., 128:].transpose(1, 2)
    do = rnd(B, S, H, 128).transpose(1, 2)
    o, lse = ref.flash_attention_ref(q, k, v, causal, 0, return_lse=True)
    before = build.LAUNCHES["flash_attention_bwd (192, 128)"]
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention_bwd (192, 128)"] == before + 1
    assert got[2].shape == (B, Hkv, S, 128)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, 0)
    for g, w in zip(got, want):
        assert_grad_close(g, w)
    # the Function, with v the strided view of a leaf
    grads = []
    for fn in (flash_attention, lambda *a, causal: ref.flash_attention_ref(
            *a, causal, 0)):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q, k, kv)]
        out = fn(leaves[0], leaves[1], leaves[2][..., 128:].transpose(1, 2),
                 causal=causal)
        grads.append(torch.autograd.grad(out, leaves, do))
        if fn is flash_attention:
            assert_close(out, o)
    for g, w in zip(*grads):
        assert_grad_close(g, w)


def _bwd_inputs(device, B, H, Hkv, S, d, causal, window, seed=7):
    """bf16 q, k, v, dO and the plain forward's o and lse; d, or (d_qk,
    d_v)."""
    d, dv = d if isinstance(d, tuple) else (d, d)
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = torch.bfloat16
    q = torch.randn(B, H, S, d, generator=gen, device=device).to(bf16)
    k = torch.randn(B, Hkv, S, d, generator=gen, device=device).to(bf16)
    v = torch.randn(B, Hkv, S, dv, generator=gen, device=device).to(bf16)
    do = torch.randn(B, H, S, dv, generator=gen, device=device).to(bf16)
    o, lse = ref.flash_attention_ref(q, k, v, causal, window,
                                     return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("case", [((1, 40, 8, 512, 128), True, 0),
                                  ((1, 32, 32, 512, 64), True, 0),
                                  ((1, 10, 2, 300, 128), False, 100),
                                  ((1, 8, 8, 512, (192, 128)), True, 0),
                                  ((1, 8, 4, 200, (192, 128)), False, 0)],
                         ids=["qwen3-gqa", "opt", "gqa5-noncausal-window",
                              "mla", "mla-gqa2-noncausal"])
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


@pytest.mark.parametrize("case,seed", [
    ((1, 4, 2, 100, 64, True, 30), 3790),
    ((1, 8, 4, 200, (192, 128), True, 0), 0)], ids=["seed3790", "mla"])
def test_flash_bwd_kernels_meet_their_emulation(cuda, case, seed):
    """The bf16 kernels on the card against their CPU emulation
    (tests/flash_bwd_emulation.py, the kernels' rounding over their own
    tiles and column steps) on the same inputs: the input of 12,000 random
    cases where one cast of dQ's dS broke the tolerance (seed 3790, which
    chose the split), and a (192, 128) case with G = 2. Each gradient of
    the kernels within 2^-7·max|g| of the emulation's, and the kernels'
    margin to the plain backward (max|Δ| over that tolerance) within 0.25
    of the emulation's: the tensor cores sum 16 products at a time in
    their own order, so the two meet up to one-ulp flips."""
    from flash_bwd_emulation import (KERNEL_SPLIT,
                                     emulate_bf16_flash_bwd_kernel, inputs,
                                     worst)
    causal, window = case[5], case[6]
    cpu = inputs(case, seed)
    emu = emulate_bf16_flash_bwd_kernel(*cpu, causal, window, **KERNEL_SPLIT)
    got = flash_attention_bwd(*(t.to(cuda) for t in cpu), causal=causal,
                              window=window)
    plain = ref.flash_attention_bwd_ref(*cpu, causal, window)
    for name, g, e, w in zip(("dq", "dk", "dv"), got, emu, plain):
        g = g.cpu()
        apart, mk, me = worst([g], [e]), worst([g], [w]), worst([e], [w])
        print(f"{case} seed {seed} {name}: kernels vs emulation {apart:.3f}"
              f", margins to the plain backward: kernels {mk:.3f}, "
              f"emulation {me:.3f} (of 2^-7·max|g|)")
        assert apart <= 1.0 and mk <= 1.0 and abs(mk - me) <= 0.25


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


# the rmsnorm backward's shapes: the qwen3-14b block and qk-norm rows, MLA's
# 512 and 1536, small and ragged rows, mixtral's 6144, the widest d_model
# of the configs (8192) and the branch that rereads rows wider than that
NORM_BWD_SHAPES = [(1, 512, 5120), (1, 512, 40, 128), (1, 512, 8, 128),
                   (1, 512, 512), (1, 512, 1536), (3, 7, 128), (1, 300, 5120),
                   (333, 100), (77, 1030), (1, 512, 6144), (96, 8192),
                   (17, 16384), (5, 16400)]


def _norm_bwd_inputs(cuda, shape, dtype, seed=7):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    D = shape[-1]
    x = (torch.randn(shape, generator=gen, device=cuda) * 3.0).to(dtype)
    dy = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    s = 1.0 + 0.5 * torch.randn(D, generator=gen, device=cuda)
    return x, s, dy


@pytest.mark.parametrize("shape", NORM_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_matches_plain(cuda, shape, dtype):
    x, s, dy = _norm_bwd_inputs(cuda, shape, dtype)
    D = shape[-1]
    assert rmsnorm_bwd_plan((x, s, dy))["reread"] == (D > 8192)
    before = build.LAUNCHES["rmsnorm_bwd"]
    dx, ds = rmsnorm_bwd(x, s, dy)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rmsnorm_bwd"] == before + 1
    wx, ws = ref.rmsnorm_bwd_ref(x, s, dy)
    assert_grad_close(dx, wx)
    assert_grad_close(ds, ws)
    # through autograd: the single, and the pair (one backward launch)
    xa, sa = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    got = torch.autograd.grad(rmsnorm(xa, sa), (xa, sa), dy)
    assert_grad_close(got[0], wx)
    assert_grad_close(got[1], ws)
    if D <= 1024:
        n0 = build.LAUNCHES["rmsnorm_bwd"]
        yq, yk = rmsnorm_pair(xa, sa, xa, sa)
        gq = torch.autograd.grad((yq, yk), (xa, sa), (dy, dy))
        assert build.LAUNCHES["rmsnorm_bwd"] == n0 + 1
        assert_grad_close(gq[0], (wx.float() * 2).to(dtype))
        assert_grad_close(gq[1], ws * 2)


@pytest.mark.parametrize("shape", NORM_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_two_calls_are_bit_equal(cuda, shape, dtype):
    """dx and dscale of two calls are bit-equal (no float atomics: dscale's
    blocks and clusters are summed in a fixed order), for one tensor and,
    at widths up to 1024, for the pair with k's own rows and scale."""
    x, s, dy = _norm_bwd_inputs(cuda, shape, dtype)
    first, second = rmsnorm_bwd(x, s, dy), rmsnorm_bwd(x, s, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    if shape[-1] <= 1024:
        xk, sk, dyk = _norm_bwd_inputs(cuda, (41, shape[-1]), dtype, seed=8)
        first = rmsnorm_pair_bwd(x, s, dy, xk, sk, dyk)
        second = rmsnorm_pair_bwd(x, s, dy, xk, sk, dyk)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        want = (*ref.rmsnorm_bwd_ref(x, s, dy), *ref.rmsnorm_bwd_ref(
            xk, sk, dyk))
        for g, w in zip(first, want):
            assert_grad_close(g, w)


def test_rmsnorm_bwd_above_the_old_row_limit(cuda):
    """Rows of 128 in bf16 beyond the three-launch backward's 65535 chunks
    of 64 rows (4,194,240): 4,198,400 rows, 3.2 GB of x, dy and dx; the
    grid stays the card's, its blocks looping over the rows."""
    rows = 65535 * 64 + 4160
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = (torch.randn(rows, 128, generator=gen, device=cuda) * 3.0).to(
        torch.bfloat16)
    dy = torch.randn(rows, 128, generator=gen, device=cuda).to(
        torch.bfloat16)
    s = 1.0 + 0.5 * torch.randn(128, generator=gen, device=cuda)
    assert rmsnorm_bwd_plan((x, s, dy))["grid"] <= 8 * (
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    dx, ds = rmsnorm_bwd(x, s, dy)
    torch.cuda.synchronize()
    wx, ws = ref.rmsnorm_bwd_ref(x, s, dy)
    assert_grad_close(dx, wx)
    assert_grad_close(ds, ws)


# (x's shape, k's shape for the pair or None, dtype, a view at an odd
# element offset: one element a pack, as at a width of no whole 16 bytes)
NORM_BWD_EMULATION_CASES = [
    ((512, 5120), None, torch.bfloat16, False),
    ((20480, 128), (4096, 128), torch.bfloat16, False),
    ((512, 512), None, torch.bfloat16, False),
    ((512, 1536), None, torch.bfloat16, False),
    ((512, 5120), None, torch.float32, False),
    ((77, 1030), None, torch.float32, False),
    ((333, 100), (41, 100), torch.bfloat16, True),
    ((17, 16384), None, torch.bfloat16, False),
]


@pytest.mark.parametrize("case", NORM_BWD_EMULATION_CASES)
def test_rmsnorm_bwd_kernel_meets_its_emulation(cuda, case):
    """The card's backward against its CPU emulation
    (tests/rmsnorm_bwd_emulation.py: the kernel's f32 operations in its
    order, at the geometry the launch reports) on the same inputs: dscale
    within 2^-20·max|dscale| (the emulation's fused multiply-adds round
    twice where the card's round once), dx within 2^-8·max|dx| (half the
    tolerance to the plain version). Prints the distances."""
    import rmsnorm_bwd_emulation as emu
    q_shape, k_shape, dtype, odd = case
    tensors = []
    for i, shape in enumerate((q_shape, k_shape) if k_shape else (q_shape,)):
        x, s, dy = _norm_bwd_inputs(cuda, shape, dtype, seed=10 + i)
        if odd:
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
            x = buf[1:].view(x.shape).copy_(x)
        tensors.append((x, s, dy))
    plan = {k: v for k, v in rmsnorm_bwd_plan(*tensors).items()
            if k in ("V", "G", "grid")}
    got = (rmsnorm_pair_bwd(*tensors[0], *tensors[1]) if k_shape
           else rmsnorm_bwd(*tensors[0]))
    V = 16 // tensors[0][0].element_size()
    assert plan["V"] == (1 if odd or q_shape[-1] % V else V)
    emulated = emu.emulate([tuple(t.float().cpu().numpy() for t in ts)
                            for ts in tensors], **plan)
    for i, (dx, ds) in enumerate(emulated):
        gx, gs = got[2 * i].float().cpu().numpy(), got[2 * i + 1].cpu().numpy()
        ex = emu.to_bf16(dx) if dtype == torch.bfloat16 else dx
        dx_apart = float(np.abs(gx - ex).max() / np.abs(ex).max())
        ds_apart = float(np.abs(gs - ds).max() / np.abs(ds).max())
        same = float((gx == ex).mean())
        print(f"{case} {plan} tensor {i}: dx apart {dx_apart:.2e} of "
              f"max|dx| ({same:.6f} of elements equal), dscale apart "
              f"{ds_apart:.2e} of max|dscale|")
        assert dx_apart <= 2.0 ** -8 and ds_apart <= 2.0 ** -20


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


def fo_small_round(algorithm, optimizer, device, arch=None):
    """One small f32 FedAvg or FedLoRA round (olmo-1b for FedAvg, qwen3-14b
    with qk-norm for FedLoRA, both at d_head 64; or ``arch`` widened by
    ``card_smoke_config``, deepseek-v2-236b's MLA to (192, 128)) on
    ``device``: the new tree's leaves."""
    from repro_torch.configs import card_smoke_config
    from repro_torch.core import prng
    from repro_torch.core.baselines import fedavg_round, fedlora_round
    from repro_torch.models import init_params, untie_params
    from repro_torch.optim import init_lora
    from repro_torch.utils import tree
    arch = arch or ("olmo-1b" if algorithm == "fedavg" else "qwen3-14b")
    cfg = card_smoke_config(arch, 2 if arch == "olmo-1b" else 1)
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


@pytest.mark.parametrize("algorithm,optimizer,arch", [
    ("fedavg", "sgd", None), ("fedavg", "adamw", None),
    ("fedlora", "sgd", None), ("fedavg", "sgd", "deepseek-v2-236b"),
    ("fedavg", "sgd", "jamba-1.5-large-398b"),
    ("fedlora", "sgd", "jamba-1.5-large-398b"),
    ("fedavg", "sgd", "xlstm-350m"), ("fedlora", "sgd", "xlstm-350m")])
def test_fo_round_card_matches_cpu(cuda, algorithm, optimizer, arch):
    """One small f32 first-order round on the card (the forward and
    backward kernels; on deepseek-v2-236b the flash backward at (192, 128)
    and the rmsnorm backward of the MLA norms; on jamba-1.5-large-398b the
    selective scan's backward at d_state 4; on xlstm-350m, which has no
    attention, the sLSTM backward at head dim 32) against the same round
    on the CPU (their plain versions): the new tree within 1e-4."""
    before = dict(build.LAUNCHES)
    got = fo_small_round(algorithm, optimizer, cuda, arch)
    keys = () if arch == "xlstm-350m" else ("flash_attention_bwd",)
    if algorithm == "fedlora":
        keys += ("rmsnorm_bwd",)
    if arch == "deepseek-v2-236b":
        keys += ("rmsnorm_bwd", "flash_attention_bwd (192, 128)")
    if arch == "jamba-1.5-large-398b":
        keys += ("rmsnorm_bwd", "selective_scan_bwd")
    if arch == "xlstm-350m":
        keys += ("rmsnorm_bwd", "slstm_bwd")
    for k in keys:
        assert build.LAUNCHES[k] > before.get(k, 0)
    want = fo_small_round(algorithm, optimizer, torch.device("cpu"), arch)
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


# ---------------------------------------------------------------------------
# checkpoints on the card: exact round trips and an exact resume
# ---------------------------------------------------------------------------

def _ckpt_tree(device):
    gen = torch.Generator(device="cpu").manual_seed(21)
    return {"w": torch.randn(64, 33, generator=gen).to(torch.bfloat16),
            "b": {"f": torch.randn(7, generator=gen),
                  "i": torch.arange(-3, 9, dtype=torch.int32)}}


def _to(t, device):
    from repro_torch.utils import tree
    return tree.tree_map(lambda a: a.to(device), t)


def test_ckpt_cuda_leaves_round_trip_exactly(cuda, tmp_path):
    """bf16, f32 and int32 leaves on the card saved and restored onto the
    card: bit-equal, same dtypes, on the card."""
    from repro_torch.ckpt import restore_params, save_params
    from repro_torch.utils import tree
    src = _to(_ckpt_tree("cpu"), cuda)
    save_params(str(tmp_path), 0, src)
    got, meta = restore_params(str(tmp_path), src)
    assert meta["dtypes"] == {"w": "bfloat16", "b/f": "float32",
                              "b/i": "int32"}
    for a, b in zip(tree.leaves(got), tree.leaves(src)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


def test_ckpt_cpu_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A checkpoint written from CPU tensors restores onto the card through
    ``device=``, its template on the CPU, bit-equal."""
    from repro_torch.ckpt import Checkpointer
    from repro_torch.utils import tree
    src = _ckpt_tree("cpu")
    ck = Checkpointer(str(tmp_path))
    ck.save(5, src, block=True)
    got, meta = ck.restore(src, device=cuda)
    assert meta["step"] == 5
    for a, b in zip(tree.leaves(got), tree.leaves(src)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("algorithm,opts", [
    ("mu_splitfed", {"aggregation": "seed_replay"}),
    ("gas", {"aggregation": "seed_replay"}), ("fedlora", {})])
def test_scan_resume_on_the_card_is_exact(cuda, tmp_path, algorithm, opts):
    """A small bf16 run on the card (counter noise for the zeroth-order
    ones, so zo_update and zo_replay launch; FedLoRA's backward kernels),
    4 rounds in 'scan' chunks of 2, against a run of 2 rounds checkpointed
    and resumed for rounds 2-3: round losses, parameters and the state
    torch.equal."""
    import dataclasses

    from repro_torch.ckpt import Checkpointer
    from repro_torch.configs import SFLConfig, get_config
    from repro_torch.core import engine, prng
    from repro_torch.core import straggler as strag
    from repro_torch.data import (FederatedLoader, SyntheticLM,
                                  dirichlet_partition)
    from repro_torch.models import init_params, untie_params
    from repro_torch.utils import tree
    cfg = get_config("olmo-1b", smoke=True).replace(
        d_model=128, n_heads=2, n_kv_heads=2)
    params = _to(untie_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0))), cuda)
    sfl = dataclasses.replace(
        SFLConfig(n_clients=3, tau=2, cut_units=2, participation=0.67,
                  straggler_rate=2.0), perturbation_dist="counter")
    loader = FederatedLoader(SyntheticLM(cfg.vocab_size, 64, 0),
                             dirichlet_partition(np.arange(256) % 10, 3,
                                                 alpha=0.5, seed=0), 1,
                             seed=0)
    sched = strag.make_schedule(
        0, 4, population=strag.ClientPopulation.resolve(sfl), t_server=0.5)
    key = prng.PRNGKey(0)

    def run(p, rounds, **kw):
        return engine.run_rounds(algorithm, cfg, sfl, p, loader.round_batch,
                                 sched, key, rounds=rounds, chunk_size=2,
                                 mode="scan", **opts, **kw)

    full = run(params, 4)
    ck = Checkpointer(str(tmp_path))
    part1 = run(params, 2, checkpointer=ck, ckpt_every=2)
    p2, s2, meta = engine.restore_run(ck, algorithm, cfg, sfl, params,
                                      loader.round_batch, **opts)
    assert meta["step"] == 1
    part2 = run(p2, 4, start_round=2, state=s2)
    assert np.array_equal(full.round_loss,
                          np.concatenate([part1.round_loss,
                                          part2.round_loss]))
    for tag in ("params", "state"):
        got = tree.path_leaves(getattr(part2, tag))
        want = tree.path_leaves(getattr(full, tag))
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, a), (_, b) in zip(got, want):
            assert a.is_cuda and torch.equal(a, b), k


def _async_setup(timeline):
    from repro_torch.configs import SFLConfig, get_config
    from repro_torch.core import straggler as strag
    from repro_torch.core.faults import FaultPlan
    from repro_torch.data import (FederatedLoader, SyntheticLM,
                                  dirichlet_partition)
    from repro_torch.models import init_params, untie_params
    cfg = get_config("olmo-1b", smoke=True).replace(
        d_model=128, n_heads=2, n_kv_heads=2, dtype="float32")
    params = untie_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0)))
    sfl = SFLConfig(n_clients=4, tau=2, cut_units=2, participation=0.75,
                    straggler_rate=2.0, perturbation_dist="counter",
                    quorum=2, staleness_discount=0.5, timeline=timeline,
                    faults=FaultPlan(crash=0.2, loss=0.2), quorum_timeout=1.0,
                    k_max=2 if timeline == "sparse" else 0, ring_capacity=3)
    loader = FederatedLoader(SyntheticLM(cfg.vocab_size, 64, 0),
                             dirichlet_partition(np.arange(256) % 10, 4,
                                                 alpha=0.5, seed=0), 1,
                             seed=0)
    sched = strag.make_schedule(
        0, 6, population=strag.ClientPopulation.resolve(sfl), t_server=0.5,
        t_comm=0.2)
    return cfg, params, sfl, loader, sched


@pytest.mark.parametrize("timeline", ["dense", "sparse"])
def test_async_versions_card_match_cpu(cuda, timeline):
    """Six small f32 semi-async versions (quorum 2, discount 0.5, crash
    and loss faults with a quorum timeout; the sparse ring at k_max 2,
    capacity 3) on the card against the same versions on the CPU: apply
    weights and round times exact, the store's keys exact, losses,
    parameters and the store's coefficients within 1e-4. The counter
    kernels launch."""
    from repro_torch.core import engine, prng
    from repro_torch.utils import tree
    cfg, params, sfl, loader, sched = _async_setup(timeline)
    runs = []
    for d in ("cpu", cuda):
        masks = []
        before = dict(build.LAUNCHES)
        res = engine.run_rounds(
            "async_mu_splitfed", cfg, sfl, _to(params, d), loader.round_batch,
            sched, prng.PRNGKey(0), rounds=6, chunk_size=2, mode="async",
            batch_subset_fn=(loader.subset_batch if timeline == "sparse"
                             else None),
            chunk_callback=lambda i, p, s: masks.append(i.masks))
        runs.append((res, np.concatenate(masks),
                     {k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                      for k in ("zo_update", "zo_replay")}))
    (cpu, cpu_masks, cpu_n), (card, card_masks, card_n) = runs
    assert cpu_n == {"zo_update": 0, "zo_replay": 0}
    assert card_n["zo_update"] > 0 and card_n["zo_replay"] > 0
    np.testing.assert_array_equal(card_masks, cpu_masks)
    np.testing.assert_array_equal(card.round_times, cpu.round_times)
    np.testing.assert_allclose(card.round_loss, cpu.round_loss, atol=1e-4)
    for (k, a), (_, b) in zip(tree.path_leaves(card.params),
                              tree.path_leaves(cpu.params)):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 1e-4, k
    for k, a in card.state.items():
        b = cpu.state[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == np.uint32 and np.array_equal(a, b), k
        else:
            assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 1e-4, k


def test_store_scatter_and_gather_on_the_card(cuda):
    """The ring store's scatter with pad slots (= capacity, dropped, as
    the reference's mode='drop') and its clamped gather on CUDA tensors,
    against the same on the CPU; host keys stay numpy."""
    from repro_torch.configs import SFLConfig
    from repro_torch.core import events
    sfl = SFLConfig(n_clients=8, tau=3, n_perturbations=2,
                    timeline="sparse", quorum=2, k_max=4, ring_capacity=5)
    assert events.resolve_store_geometry(sfl) == (4, 5)
    rng = np.random.default_rng(0)
    slots = np.array([3, 5, 0, 5])          # two pads at capacity 5
    fresh = {"srv_keys": rng.integers(0, 2**32, (4, 3, 2, 2),
                                      dtype=np.uint32),
             "srv_coeffs": rng.standard_normal((4, 3, 2)),
             "ukey": rng.integers(0, 2**32, (4, 2), dtype=np.uint32),
             "ccoeff": rng.standard_normal(4), "loss0": rng.random(4)}
    take = np.array([0, 3, 5, 5])           # pads clamp to slot 4
    outs = []
    for d in ("cpu", cuda):
        store = events.init_store(sfl, d)
        assert store["loss0"].device.type == torch.device(d).type
        f = {k: (v if v.dtype == np.uint32 else
                 torch.tensor(v, dtype=torch.float32, device=d))
             for k, v in fresh.items()}
        new = events.scatter_rows(store, slots, f)
        assert float(store["ccoeff"].abs().sum()) == 0   # a copy
        outs.append({k: events.gather_rows(new[k], take) for k in new})
        outs[-1]["all"] = new
    cpu, card = outs
    for k, v in fresh.items():
        got = card["all"][k]
        got = got if isinstance(got, np.ndarray) else got.cpu().numpy()
        want = np.zeros_like(got)
        want[[3, 0]] = np.asarray(v, got.dtype)[[0, 2]]
        assert np.array_equal(got, want), k
        g = card[k] if isinstance(card[k], np.ndarray) else card[k].cpu()
        c = cpu[k] if isinstance(cpu[k], np.ndarray) else cpu[k]
        assert np.array_equal(np.asarray(g), np.asarray(c)), k
        assert np.array_equal(np.asarray(g)[2], want[4]), k


def test_apply_moe_card_matches_cpu(cuda):
    """mixtral-8x22b SMOKE's MoE block in f32 (4 experts top-2, capacity
    1.25, tokens dropped) on the card against the CPU: expert indices and
    kept mask equal (the router product in full f32 on both), the aux
    within 1e-6 and the output within 1e-5 of its largest magnitude (the
    expert products, in another order on the card, reach |y| ~ 10^2)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, moe
    from repro_torch.utils import tree
    cfg = get_config("mixtral-8x22b", smoke=True).replace(dtype="float32")
    p = tree.tree_map(lambda a: a[0], init_params(
        cfg, torch.Generator().manual_seed(0))["units"]["b0"]["ffn"])
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((2, 64, 64))
                          + 1.5 * rng.standard_normal(64)).astype(np.float32))
    outs = []
    for d in ("cpu", cuda):
        pd = tree.tree_map(lambda a: a.to(d), p)
        xd = x.to(d)
        _, idx, _ = moe.route(cfg, pd, xd)
        _, kept = moe.dispatch_slots(idx, 4, moe.capacity(cfg, 64))
        out, aux = moe.apply_moe(cfg, pd, xd)
        outs.append((idx.cpu(), kept.cpu(), out.cpu(), float(aux)))
    (i0, k0, o0, a0), (i1, k1, o1, a1) = outs
    assert torch.equal(i0, i1) and torch.equal(k0, k1)
    assert not bool(k0.all())
    assert abs(a0 - a1) <= 1e-6
    assert float((o1 - o0).abs().max()) <= 1e-5 * float(o0.abs().max())


@pytest.mark.parametrize("arch,S", [("mixtral-8x22b", 40), ("qwen3-14b", 24),
                                    ("deepseek-v2-236b", 24),
                                    ("jamba-1.5-large-398b", 24)])
def test_serving_card_matches_cpu(cuda, arch, S):
    """SMOKE serving in f32, widened by ``configs.card_smoke_config`` to
    head dims the flash kernel takes (d_head 64 with 1 kv head; MLA's
    (192, 128) pair), at SMOKE's capacity factor, as chip_smoke.py's small
    serving runs it: ``serve.generate`` of 8 greedy tokens (mixtral past
    its window of 32) on the card against the CPU, tokens equal and the
    full forward over prompt and tokens within 1e-4 of max(|logits|, 1);
    the card's request launches flash and rmsnorm."""
    from repro_torch.configs import card_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params, logits_fn
    from repro_torch.utils import tree
    cfg = card_smoke_config(arch, 1)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)))
    outs = []
    for d in ("cpu", cuda):
        p = tree.tree_map(lambda a: a.to(d), params)
        before = dict(build.LAUNCHES)
        out = serve.generate(cfg, p, {"tokens": toks.to(d)}, S, 8)
        n = {k: build.LAUNCHES[k] - before.get(k, 0)
             for k in ("flash_attention", "rmsnorm")}
        with torch.inference_mode():
            full = logits_fn(cfg, p, {"tokens": torch.cat([toks.to(d), out],
                                                          1)})
        outs.append((out.cpu(), full.cpu(), n))
    (t0, l0, _), (t1, l1, n) = outs
    assert torch.equal(t0, t1)
    assert float((l1 - l0).abs().max()) <= \
        1e-4 * max(float(l0.abs().max()), 1.0)
    assert n["flash_attention"] > 0 and n["rmsnorm"] > 0


def scan_inputs(B, S, d_in, N, dtype, device, h0_scale=0.5, seed=5):
    """The selective scan's inputs as a Mamba block gives them: x the
    silu of a normal, dt a normal (the product before the bias), A_log,
    D and dt_bias at the reference's init (softplus⁻¹(0.01) ± 1), B and
    C normal, h0 a normal times ``h0_scale``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = torch.nn.functional.silu(randn(B, S, d_in) * 2.0).to(dtype)
    z = randn(B, S, d_in).to(dtype)
    A_log = torch.log(torch.arange(1, N + 1.0, device=device)).expand(
        d_in, N).contiguous()
    bias = float(np.log(np.expm1(0.01))) + randn(d_in)
    return (x, randn(B, S, d_in), z, randn(B, S, N), randn(B, S, N), A_log,
            1.0 + 0.1 * randn(d_in), bias, randn(B, d_in, N) * h0_scale)


def assert_scan_close(got, want):
    """y: f32 within 1e-5 of max|y|, bf16 within two ulps of each element
    plus 1e-5 of max|y|; h_last (f32) within 1e-5 of max|h|."""
    (y, h), (wy, wh) = got, want
    assert y.shape == wy.shape and y.dtype == wy.dtype
    assert bool(torch.isfinite(y.float()).all())
    scale = float(wy.float().abs().max())
    d = (y.float() - wy.float()).abs()
    if y.dtype == torch.bfloat16:
        assert bool((d <= 2.0 ** -6 * wy.float().abs() + 1e-5 * scale).all())
    else:
        assert float(d.max()) <= 1e-5 * scale
    assert h.dtype == torch.float32
    assert float((h - wh).abs().max()) <= 1e-5 * float(wh.abs().max())


@pytest.mark.parametrize("case", [(2, 1, 256, 4), (2, 40, 256, 4),
                                  (1, 512, 1024, 4), (2, 1, 512, 16),
                                  (2, 40, 512, 16), (1, 512, 16384, 16),
                                  (1, 40, 100, 16), (2, 33, 100, 16),
                                  (2, 33, 100, 4), (1, 65, 300, 16)],
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("h0_scale", [0.0, 0.5], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_matches_plain(cuda, case, h0_scale, dtype):
    """(B, S, d_in, N): one token, 33, 40, 65, 512 (33, 40 and 65 end
    in a part of a 32-token chunk); N 4 and 16, each dtype, so every
    template instance (T, N, G) the kernel ships; d_in 100 and 300 leave
    the last block ragged (32 channels a block at N = 16, 64 at N = 4).
    One launch a call."""
    args = scan_inputs(*case, dtype, cuda, h0_scale)
    before = build.LAUNCHES["selective_scan"]
    got = selective_scan(*args)
    assert build.LAUNCHES["selective_scan"] == before + 1
    assert_scan_close(got, ref.selective_scan_ref(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_is_deterministic_and_takes_h0_as_h_out(cuda, dtype):
    """Two launches give bit-equal y and h_last; with h_out = h0 (decode's
    in-place state) the results equal a launch into a new h_last."""
    args = scan_inputs(1, 300, 2048, 16, dtype, cuda)
    y0, h0 = selective_scan(*args)
    y1, h1 = selective_scan(*args)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    state = args[-1].clone()
    y2, h2 = selective_scan(*args[:-1], state, h_out=state)
    assert h2.data_ptr() == state.data_ptr()
    assert torch.equal(y2, y0) and torch.equal(state, h0)


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_reads_z_b_c_in_place(cuda, N, dtype):
    """z as the second half of a (B, S, 2·d_in) tensor and B and C as
    slices of one (B, S, 7 + 2N) tensor, as the Mamba block passes them,
    give y and h_last bit-equal to contiguous copies, one launch; at one
    token too. A z whose last dimension is strided, or whose rows are not
    evenly spaced over (B, S), raises."""
    for S in (40, 1):
        args = scan_inputs(2, S, 100, N, dtype, cuda)
        x, dt, z, Bc, Cc, *rest = args
        xz = torch.randn(2, S, 200, device=cuda).to(dtype)
        xz[..., 100:] = z
        dbl = torch.randn(2, S, 7 + 2 * N, device=cuda)
        dbl[..., 7:7 + N], dbl[..., 7 + N:] = Bc, Cc
        views = (xz[..., 100:], dbl[..., 7:7 + N], dbl[..., 7 + N:])
        assert not any(v.is_contiguous() for v in views)
        before = build.LAUNCHES["selective_scan"]
        y, h = selective_scan(x, dt, *views, *rest)
        assert build.LAUNCHES["selective_scan"] == before + 1
        y0, h0 = selective_scan(*args)
        assert torch.equal(y, y0) and torch.equal(h, h0)
    args = list(scan_inputs(2, 8, 64, N, dtype, cuda))
    bad = list(args)
    bad[2] = torch.empty(2, 8, 128, dtype=dtype, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="z's last dimension must be "
                                         "contiguous"):
        selective_scan(*bad)
    bad = list(args)
    bad[2] = torch.empty(8, 2, 64, dtype=dtype, device=cuda).transpose(0, 1)
    with pytest.raises(ValueError, match="z's rows must be evenly spaced"):
        selective_scan(*bad)


def test_selective_scan_plan_matches_the_wrapper(cuda):
    """Each instance's launch geometry from the library: its lanes a
    channel equal the wrapper's LANES (the order of the sum over n that
    tests/test_torch_scan_order.py models), the lanes times the channels
    make the threads, the chunk is the wrapper's CHUNK (the h_chunks it
    allocates for the backward), and an SM holds at least one block."""
    import ctypes
    from repro_torch.kernels.selective_scan import CHUNK
    for N in (4, 16):
        for code in (0, 1):
            plan = (ctypes.c_int * 7)()
            assert build.library().selective_scan_plan(N, code, plan) == 0
            G, channels, chunk, threads, regs, smem, blocks = plan
            assert G == LANES[N] and G * channels == threads
            assert chunk == CHUNK and chunk % G == 0
            assert regs > 0 and smem > 0 and blocks >= 1
    plan = (ctypes.c_int * 7)()
    assert build.library().selective_scan_plan(8, 0, plan) != 0


def test_selective_scan_raises_on_what_it_does_not_take(cuda):
    """A wrong dtype, a non-contiguous input, a mismatched shape, an input
    on the CPU and d_state 8 (no kernel instance) raise."""
    args = list(scan_inputs(1, 8, 64, 4, torch.float32, cuda))
    with pytest.raises(TypeError):
        selective_scan(args[0].half(), *args[1:])
    bad = list(args)
    bad[2] = args[2].to(torch.bfloat16)             # z's dtype differs
    with pytest.raises(ValueError, match="z must be"):
        selective_scan(*bad)
    bad = list(args)
    bad[1] = torch.empty(1, 8, 128, device=cuda)[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan(*bad)
    bad = list(args)
    bad[3] = args[3][:, :4]
    with pytest.raises(ValueError, match="Bc must be"):
        selective_scan(*bad)
    bad = list(args)
    bad[6] = args[6].cpu()
    with pytest.raises(ValueError, match="D must be"):
        selective_scan(*bad)
    with pytest.raises(ValueError, match="d_state 8"):
        selective_scan(*scan_inputs(1, 8, 64, 8, torch.float32, cuda))


# ---------------------------------------------------------------------------
# the selective scan's backward
# ---------------------------------------------------------------------------

def assert_scan_grads_close(got, want):
    """Each of the nine gradients: types and shapes equal, finite, within
    1e-5 (f32) or 2^-7 (bf16) of its largest magnitude."""
    tol = 1e-5 if want[0].dtype == torch.float32 else 2.0 ** -7
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(torch.isfinite(g.float()).all())
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale


def scan_views(args):
    """z, B and C as the Mamba block passes them: z the second half of a
    (B, S, 2·d_in) tensor, B and C slices of one (B, S, 7 + 2N) tensor."""
    x, dt, z, Bc, Cc, *rest = args
    B, S, d_in = z.shape
    N = Bc.shape[-1]
    xz = torch.randn(B, S, 2 * d_in, device=z.device).to(z.dtype)
    xz[..., d_in:] = z
    dbl = torch.randn(B, S, 7 + 2 * N, device=Bc.device)
    dbl[..., 7:7 + N], dbl[..., 7 + N:] = Bc, Cc
    return (x, dt, xz[..., d_in:], dbl[..., 7:7 + N], dbl[..., 7 + N:],
            *rest)


def scan_cotangents(B, S, d_in, N, dtype, device, seed=9):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(B, S, d_in, generator=g, device=device).to(dtype),
            torch.randn(B, d_in, N, generator=g, device=device))


@pytest.mark.parametrize("S", [1, 31, 32, 33, 300])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_matches_plain(cuda, S, N, dtype):
    """The backward kernel on the h the forward saved at its chunk starts,
    z, B and C as strided views, against ref.selective_scan_bwd_ref: B 2,
    d_in 100 (the last block ragged), nonzero h0 and dh_last; S ending in
    a part of a 32-token chunk, on one, at one token; every gradient
    within 1e-5 (f32) or 2^-7 (bf16) of its largest magnitude. One call
    (two launches) counted once."""
    from repro_torch.kernels.selective_scan import (_launch,
                                                    selective_scan_bwd)
    args = scan_views(scan_inputs(2, S, 100, N, dtype, cuda))
    dy, dh_last = scan_cotangents(2, S, 100, N, dtype, cuda)
    _, _, hc = _launch(*args, None, save=True)
    assert tuple(hc.shape) == (2, -(-S // 32), 100, N)
    before = build.LAUNCHES["selective_scan_bwd"]
    got = selective_scan_bwd(*args, hc, dy, dh_last)
    assert build.LAUNCHES["selective_scan_bwd"] == before + 1
    assert_scan_grads_close(got, ref.selective_scan_bwd_ref(*args, dy,
                                                            dh_last))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_is_deterministic(cuda, dtype):
    """Two calls give bit-equal gradients (no atomics: per-block partials
    summed in block order); strided z, B and C equal contiguous copies; no
    dh_last equals a zero one; the forward that saves chunk starts gives
    y and h_last bit-equal to the one that does not."""
    from repro_torch.kernels.selective_scan import (_launch,
                                                    selective_scan_bwd)
    args = scan_inputs(1, 300, 2048, 16, dtype, cuda)
    dy, _ = scan_cotangents(1, 300, 2048, 16, dtype, cuda)
    y0, h0, hc = _launch(*args, None, save=True)
    y1, h1 = selective_scan(*args)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    one = selective_scan_bwd(*args, hc, dy, None)
    two = selective_scan_bwd(*scan_views(args), hc, dy,
                             torch.zeros_like(h0))
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("shape", [(3, 38, 96), (1, 33, 288),
                                   (1, 4097, 64), (2, 70, 99)])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_cluster_and_chunk_edges(cuda, shape, N, dtype):
    """The backward where its geometry has edges: 3 and 9 blocks of 32
    channels (d_in 96, 288: the grid rounded up to clusters of 8, blocks
    past d_in computing on zeros), B = 3, a last chunk of 6 tokens (a whole
    sub-chunk and part of one), S 33 and 4097 (a last chunk of one token:
    it and its sub-chunk both partial), and d_in 99 (odd: the stage copies
    element by element, bf16 through registers). Every gradient within
    1e-5 (f32) or 2^-7 (bf16) of its largest magnitude of the plain
    version; two calls bit-equal."""
    from repro_torch.kernels.selective_scan import (_launch,
                                                    selective_scan_bwd)
    B, S, d_in = shape
    args = scan_views(scan_inputs(B, S, d_in, N, dtype, cuda))
    dy, dh_last = scan_cotangents(B, S, d_in, N, dtype, cuda)
    _, _, hc = _launch(*args, None, save=True)
    got = selective_scan_bwd(*args, hc, dy, dh_last)
    assert_scan_grads_close(got, ref.selective_scan_bwd_ref(*args, dy,
                                                            dh_last))
    again = selective_scan_bwd(*args, hc, dy, dh_last)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_forward_unchanged_by_saving(cuda, N, dtype):
    """The forward the backward reads from: the saving launch (one forward
    launch, no backward) gives y and h_last bit-equal to the launch that
    saves nothing, and its h_chunks[:, k] bit-equal to h_last of a forward
    over the first 32·k tokens (the saved states are the forward's own);
    h_chunks[:, 0] is h0."""
    from repro_torch.kernels.selective_scan import _launch
    args = scan_inputs(2, 100, 160, N, dtype, cuda)
    before = dict(build.LAUNCHES)
    y0, h0, hc = _launch(*args, None, save=True)
    assert build.LAUNCHES["selective_scan"] == \
        before.get("selective_scan", 0) + 1
    assert build.LAUNCHES["selective_scan_bwd"] == \
        before.get("selective_scan_bwd", 0)
    y1, h1 = selective_scan(*args)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    assert tuple(hc.shape) == (2, 4, 160, N)
    assert torch.equal(hc[:, 0], args[-1])
    for k in (1, 2, 3):
        head = [t[:, :32 * k].contiguous() if t.dim() == 3 and
                t.shape[1] == 100 else t for t in args]
        _, hk = selective_scan(*head)
        assert torch.equal(hc[:, k], hk)


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_autograd_card_matches_cpu(cuda, N, dtype):
    """``selective_scan`` under autograd (every input requiring a
    gradient) on the card, its backward the kernel, against the same on
    the CPU, where the plain forward and backward run: y and h_last as the
    forward's tolerance, each input's gradient within 1e-5 (f32) or 2^-7
    (bf16) of its largest magnitude; one forward and one backward launch.
    With h_out under autograd it raises."""
    args = scan_inputs(2, 40, 256, N, dtype, cuda)
    dy, dh_last = scan_cotangents(2, 40, 256, N, dtype, cuda)
    outs = {}
    for d in (cuda, torch.device("cpu")):
        ins = [t.detach().to(d).requires_grad_() for t in args]
        before = dict(build.LAUNCHES)
        y, h = selective_scan(*ins)
        grads = torch.autograd.grad((y, h), ins, (dy.to(d), dh_last.to(d)))
        n = {k: build.LAUNCHES[k] - before.get(k, 0)
             for k in ("selective_scan", "selective_scan_bwd")}
        outs[d.type] = (y.detach().cpu(), h.detach().cpu(),
                        [g.cpu() for g in grads], n)
    (yc, hc_, gc, nc), (yg, hg, gg, ng) = outs["cuda"], outs["cpu"]
    assert nc == {"selective_scan": 1, "selective_scan_bwd": 1}
    assert ng == {"selective_scan": 0, "selective_scan_bwd": 0}
    assert_scan_close((yc, hc_), (yg, hg))
    assert_scan_grads_close(gc, gg)
    ins = [t.detach().requires_grad_() for t in args]
    with pytest.raises(ValueError, match="h_out"):
        selective_scan(*ins[:-1], ins[-1], h_out=torch.empty_like(args[-1]))


def test_selective_scan_without_grad_saves_nothing(cuda):
    """Under no_grad and inference_mode an input that requires a gradient
    takes the forward alone (the ZO and serving paths' counts): one
    forward launch, no backward, y without a grad_fn."""
    args = [t.clone().requires_grad_() for t in
            scan_inputs(1, 40, 256, 16, torch.bfloat16, cuda)]
    for ctx in (torch.no_grad, torch.inference_mode):
        before = dict(build.LAUNCHES)
        with ctx():
            y, _ = selective_scan(*args)
        assert y.grad_fn is None
        assert build.LAUNCHES["selective_scan"] == \
            before.get("selective_scan", 0) + 1
        assert build.LAUNCHES["selective_scan_bwd"] == \
            before.get("selective_scan_bwd", 0)


def test_selective_scan_bwd_plan(cuda):
    """Each backward instance's geometry from the library: the forward's
    lanes a channel, a sub-chunk a token a lane of each channel, clusters
    that divide d_in 16384's 512 blocks, 9 block barriers a 32-token chunk,
    and every block of d_in 16384 at B = 1 resident at once (4 an SM on
    132 SMs, and as many clusters as the grid holds)."""
    import ctypes
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for N in (4, 16):
        for code in (0, 1):
            plan = (ctypes.c_int * 10)()
            assert build.library().selective_scan_bwd_plan(N, code, plan) == 0
            (G, channels, sub, threads, regs, smem, blocks, cluster,
             barriers, clusters) = plan
            assert G == LANES[N] and G * channels == threads
            assert sub == G and regs > 0 and 0 < smem <= 56 * 1024
            assert cluster in (1, 2, 4, 8)
            assert (16384 // channels) % cluster == 0
            assert barriers == 1 + 32 // sub
            assert blocks * sms >= 16384 // channels
            assert clusters * cluster >= 16384 // channels


def slstm_inputs(B, S, H, dh, dtype, device, nonzero=True, seed=5):
    """The sLSTM kernel's inputs as an sLSTM block gives them: x_pre a
    normal times 2 in the model type (gates out of their linear range), b
    with its forget quarter at 3.0, r at its init scale 1/sqrt(dh); a
    nonzero state (c and h normal, n >= 1, m near 0) or the initial one
    (zeros, m at -1e30)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    D = H * dh
    b = torch.zeros(4 * D, device=device)
    b[2 * D:3 * D] = 3.0
    x_pre = (randn(B, S, 4 * D) * 2.0).to(dtype)
    r = randn(4, H, dh, dh) / float(np.sqrt(dh))
    if nonzero:
        state = (randn(B, H, dh), randn(B, H, dh).abs() + 1.0,
                 randn(B, H, dh) * 0.5, randn(B, H, dh) * 0.5)
    else:
        z = torch.zeros(B, H, dh, device=device)
        state = (z, z.clone(), torch.full_like(z, -1e30), z.clone())
    return (x_pre, b, r) + state


def assert_slstm_close(got, want):
    """hs: f32 within 1e-5 of max|hs|, bf16 within two ulps of each
    element plus 1e-5 of max|hs|; c, n, h within 1e-5 of each largest
    magnitude, m within 1e-5 of max(|m|, 1)."""
    (hs, st), (whs, wst) = got, want
    assert hs.shape == whs.shape and hs.dtype == whs.dtype
    assert bool(torch.isfinite(hs.float()).all())
    scale = float(whs.float().abs().max())
    d = (hs.float() - whs.float()).abs()
    if hs.dtype == torch.bfloat16:
        assert bool((d <= 2.0 ** -6 * whs.float().abs()
                     + 1e-5 * scale).all())
    else:
        assert float(d.max()) <= 1e-5 * scale
    for k, (a, w) in enumerate(zip(st, wst)):
        assert a.dtype == torch.float32 and a.shape == w.shape
        floor = 1.0 if k == 2 else 0.0
        assert float((a - w).abs().max()) <= 1e-5 * max(
            float(w.abs().max()), floor)


def slstm_rows() -> int:
    """The batch rows a cluster of the kernel (slstm_plan's field 8)."""
    import ctypes
    plan = (ctypes.c_int * 20)()
    assert build.library().slstm_plan(256, 1, plan) == 0
    return plan[8]


# (B, S, H, dh), or a B from the kernel's batch rows a cluster, R: "R+1"
# leaves a ragged last group, "3R+1" several groups and a ragged one
SLSTM_SHAPES = [(2, 1, 4, 16), (2, 40, 4, 16), (2, 40, 4, 32), (3, 40, 2, 32),
                (1, 1, 4, 256), (1, 40, 4, 256), (1, 512, 4, 256),
                (2, 65, 2, 64), (4, 512, 4, 256), (4, 1, 4, 256),
                ("R+1", 40, 4, 256), ("3R+1", 40, 4, 256),
                ("3R+1", 33, 2, 64), ("R+1", 1, 4, 256), (1, 40, 2, 16),
                (1, 33, 4, 32)]


def slstm_shape(case):
    B, *rest = case
    if isinstance(B, str):
        R = slstm_rows()
        B = {"R+1": R + 1, "3R+1": 3 * R + 1}[B]
    return (B, *rest)


@pytest.mark.parametrize("case", SLSTM_SHAPES,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("nonzero", [False, True], ids=["init", "state"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_matches_plain(cuda, case, nonzero, dtype):
    """(B, S, H, dh): xlstm SMOKE's head dim 16 and the card SMOKE's 32
    (one block a head), xlstm-350m's 256 and 64 (clusters of dh / 16);
    one token, 33, 40, 65 and 512; path 11's 4 x 512 serving prefill and
    4-row decode (one cluster a head), a B with a ragged last group of
    batch rows and one of several groups, and B = 1 (the one-row
    instance) at each head dim. One launch a call."""
    args = slstm_inputs(*slstm_shape(case), dtype, cuda, nonzero)
    before = build.LAUNCHES["slstm"]
    got = slstm(*args)
    assert build.LAUNCHES["slstm"] == before + 1
    assert_slstm_close(got, ref.slstm_ref(*args))


@pytest.mark.parametrize("dh", [32, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_is_deterministic_and_takes_the_state_as_out(cuda, dh,
                                                          dtype):
    """Two launches give bit-equal hs and state; with ``out`` the input
    state itself (decode's in-place state) the results equal a launch
    into a new state. B spans two groups of batch rows and a ragged
    third."""
    args = slstm_inputs(2 * slstm_rows() + 1, 300, 4, dh, dtype, cuda)
    hs0, st0 = slstm(*args)
    hs1, st1 = slstm(*args)
    assert torch.equal(hs0, hs1)
    assert all(torch.equal(a, b) for a, b in zip(st0, st1))
    state = [t.clone() for t in args[3:]]
    hs2, st2 = slstm(*args[:3], *state, out=state)
    assert all(a is b for a, b in zip(st2, state))
    assert torch.equal(hs2, hs0)
    assert all(torch.equal(a, b) for a, b in zip(state, st0))


def test_slstm_plan(cuda):
    """Each instance's launch geometry from the library, for a group of
    batch rows a cluster (B > 1) and for one (B = 1): one block a head at
    dh 16 and 32, a cluster of dh / columns blocks above; 4 gates x the
    block's columns x the splits of the sum over d make the threads times
    the outputs a thread, each thread's rows of r a multiple of 4, a gate
    thread for each of the group's rows and the block's columns; the
    shared memory holds the mbarriers (one a buffer, or one a buffer and
    source block), two h buffers and two sets of partial sums of the
    group's rows and the x_pre ring; the card holds at least one cluster,
    and at dh 256 the 4 heads x the groups of path 11's 4 serving rows in
    one wave."""
    import ctypes
    from repro_torch.kernels.slstm import HEAD_DIMS
    for dh in HEAD_DIMS:
        for code, elem in ((0, 4), (1, 2)):
            plan = (ctypes.c_int * 20)()
            assert build.library().slstm_plan(dh, code, plan) == 0
            rows, ahead, bars, outs = plan[8:12]
            assert rows >= 1 and ahead >= 2 and outs >= 1
            for n, (cs, cols, threads, splits, regs, smem, blocks,
                    clusters) in ((rows, plan[:8]), (1, plan[12:20])):
                assert cs * cols == dh and (cs == 1) == (dh <= 32)
                assert 4 * cols * splits == threads * outs
                assert threads % 32 == 0 and n * cols <= threads
                assert (dh // splits) % 4 == 0
                nbar = 1 if bars == 1 else cs
                assert smem == (-(-2 * nbar * 8 // 16) * 16
                                + 4 * (2 * n * dh + 2 * splits * n * 4 * cols)
                                + elem * ahead * n * 4 * cols)
                assert regs > 0 and blocks >= 1 and clusters >= 1
            if dh == 256:
                assert 4 * -(-4 // rows) <= plan[7]
    plan = (ctypes.c_int * 20)()
    assert build.library().slstm_plan(48, 0, plan) != 0


def test_slstm_takes_an_unaligned_x_pre(cuda):
    """An x_pre that is contiguous but not 16-byte aligned (a view from an
    element's offset) is read element by element and gives the same hs
    and state as an aligned copy."""
    for dtype in (torch.float32, torch.bfloat16):
        args = slstm_inputs(slstm_rows() + 1, 24, 4, 256, dtype, cuda)
        x = args[0]
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        shifted = flat[1:].view(x.shape)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
        got = slstm(shifted, *args[1:])
        want = slstm(*args)
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_slstm_raises_on_what_it_does_not_take(cuda):
    """A wrong dtype, a head dim with no instance, a mismatched or
    non-contiguous state, an input on the CPU and ``out`` under autograd
    raise."""
    args = list(slstm_inputs(1, 8, 4, 16, torch.float32, cuda))
    with pytest.raises(TypeError):
        slstm(args[0].half(), *args[1:])
    bad = list(slstm_inputs(1, 8, 2, 48, torch.float32, cuda))
    with pytest.raises(ValueError, match="head dim 48"):
        slstm(*bad)
    bad = list(args)
    bad[3] = args[3][:, :2]
    with pytest.raises(ValueError, match="c must be"):
        slstm(*bad)
    bad = list(args)
    bad[6] = torch.empty(1, 4, 32, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        slstm(*bad)
    bad = list(args)
    bad[2] = args[2].cpu()
    with pytest.raises(ValueError, match="r must be"):
        slstm(*bad)
    with pytest.raises(ValueError, match="out is not taken"):
        slstm(args[0].clone().requires_grad_(), *args[1:],
              out=[t.clone() for t in args[3:]])


def slstm_saving(args):
    """The forward that writes the backward's record: (hs, state,
    saved)."""
    from repro_torch.kernels.slstm import _launch
    return _launch(args[0], args[1], args[2], args[3:], None, save=True)


def slstm_cotangents(B, S, H, dh, dtype, device, seed=9):
    """dhs (B, S, H * dh) in ``dtype`` and the final state's four
    cotangents (B, H, dh) f32, normal."""
    g = torch.Generator(device=device).manual_seed(seed)
    dhs = torch.randn(B, S, H * dh, generator=g, device=device).to(dtype)
    return dhs, [torch.randn(B, H, dh, generator=g, device=device)
                 for _ in range(4)]


def assert_slstm_grads_close(got, want):
    """(dx_pre, db, dr, dc0, dn0, dm0, dh0): dx_pre within 2^-7 (bf16) or
    1e-5 (f32) of its largest magnitude, the rest (f32) within 1e-5 of
    theirs; finite, shapes and dtypes equal."""
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert bool(torch.isfinite(g.float()).all()), k
        tol = 2.0 ** -7 if k == 0 and g.dtype == torch.bfloat16 else 1e-5
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (k, err)


def assert_record_close(got, want):
    """The saving forward's record against ref.slstm_record_ref: the
    pre-activations and c, n, h within 1e-5 of each field's largest
    magnitude (the forward's tolerance: the recurrent product sums in
    another order), m within 1e-5 of max(|m|, 1) past token 0 and equal
    to the initial m at token 0."""
    assert got.shape == want.shape and got.dtype == want.dtype
    for k in range(8):
        g, w = got[:, :, k], want[:, :, k]
        if k == 6:
            assert torch.equal(g[:, 0], w[:, 0])
            g, w = g[:, 1:], w[:, 1:]
            if w.numel() == 0:
                continue
        floor = 1.0 if k == 6 else 0.0
        err = float((g - w).abs().max())
        assert err <= 1e-5 * max(float(w.abs().max()), floor), (k, err)


# (B, S, H, dh) as SLSTM_SHAPES: every head dim, both instances (B = 1 and
# groups of R rows), ragged and several groups, one token to 512
SLSTM_BWD_SHAPES = [(2, 1, 4, 16), (2, 40, 4, 16), (1, 40, 2, 16),
                    (2, 40, 4, 32), (1, 33, 4, 32), (3, 40, 2, 32),
                    (2, 65, 2, 64), ("3R+1", 33, 2, 64), (1, 40, 2, 128),
                    ("R+1", 40, 2, 128), (1, 1, 4, 256), (1, 40, 4, 256),
                    (1, 512, 4, 256), ("R+1", 40, 4, 256),
                    (4, 512, 4, 256), ("R+1", 1, 4, 256)]


@pytest.mark.parametrize("case", SLSTM_BWD_SHAPES,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("nonzero", [False, True], ids=["init", "state"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_bwd_matches_plain(cuda, case, nonzero, dtype):
    """The backward from the saving forward's record, with nonzero dhs and
    final-state cotangents, against ref.slstm_bwd_ref on the same record
    (so both take each max of the token's forward as the kernel's forward
    took it: a plain forward's own pre-activations differ by rounding and
    could fall on the other side of a near tie): every gradient within
    its tolerance; one launch a call."""
    args = slstm_inputs(*slstm_shape(case), dtype, cuda, nonzero)
    _, _, saved = slstm_saving(args)
    dhs, dfin = slstm_cotangents(*slstm_shape(case), dtype, cuda)
    before = build.LAUNCHES["slstm_bwd"]
    got = slstm_bwd(saved, args[2], dhs, dfin)
    assert build.LAUNCHES["slstm_bwd"] == before + 1
    assert_slstm_grads_close(got, ref.slstm_bwd_ref(*args, dhs, *dfin,
                                                    saved=saved))


@pytest.mark.parametrize("dh", [32, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_bwd_is_deterministic_and_saving_changes_no_result(cuda, dh,
                                                                 dtype):
    """The saving forward gives hs and a final state bit-equal to the
    inference forward's, and its record holds the initial state, (f32)
    each token's h before it, and agrees with the plain record
    (``assert_record_close``); two backward launches are bit-equal in
    every output, with and without db and dr (dx and the state's
    cotangents equal between the two). B spans two groups of batch rows
    and a ragged third."""
    B, S, H = 2 * slstm_rows() + 1, 300, 4
    args = slstm_inputs(B, S, H, dh, dtype, cuda)
    hs0, st0 = slstm(*args)
    hs1, st1, saved = slstm_saving(args)
    assert torch.equal(hs0, hs1)
    assert all(torch.equal(a, b) for a, b in zip(st0, st1))
    assert tuple(saved.shape) == (B, S, SAVED, H * dh)
    for k, s0 in enumerate(args[3:]):
        assert torch.equal(saved[:, 0, 4 + k], s0.reshape(B, H * dh))
    if dtype == torch.float32:
        assert torch.equal(saved[:, 1:, 7], hs0[:, :-1])
    assert_record_close(saved, ref.slstm_record_ref(*args))
    dhs, dfin = slstm_cotangents(B, S, H, dh, dtype, cuda)
    g0 = slstm_bwd(saved, args[2], dhs, dfin)
    g1 = slstm_bwd(saved, args[2], dhs, dfin)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    g2 = slstm_bwd(saved, args[2], dhs, dfin, params=False)
    assert g2[1] is None and g2[2] is None
    assert all(torch.equal(g0[k], g2[k]) for k in (0, 3, 4, 5, 6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_autograd_card_matches_cpu(cuda, dtype):
    """``slstm`` under autograd (every input requiring a gradient, a
    ragged group of batch rows) on the card, its backward the kernel,
    against the same on the CPU, where the plain forward and backward run:
    hs and the state as the forward's tolerance, every gradient as
    slstm_bwd's; one forward and one backward launch."""
    B = slstm_rows() + 1
    args = slstm_inputs(B, 40, 4, 64, dtype, cuda)
    dhs, dfin = slstm_cotangents(B, 40, 4, 64, dtype, cuda)
    outs = {}
    for d in (cuda, torch.device("cpu")):
        ins = [t.detach().to(d).requires_grad_() for t in args]
        before = dict(build.LAUNCHES)
        hs, st = slstm(*ins)
        grads = torch.autograd.grad((hs, *st), ins,
                                    (dhs.to(d), *(t.to(d) for t in dfin)))
        n = {k: build.LAUNCHES[k] - before.get(k, 0)
             for k in ("slstm", "slstm_bwd")}
        outs[d.type] = ((hs.detach().cpu(), tuple(t.detach().cpu()
                                                 for t in st)),
                        [g.cpu() for g in grads], n)
    (fc, gc, nc), (fg, gg, ng) = outs["cuda"], outs["cpu"]
    assert nc == {"slstm": 1, "slstm_bwd": 1}
    assert ng == {"slstm": 0, "slstm_bwd": 0}
    assert_slstm_close(fc, fg)
    assert_slstm_grads_close(gc, gg)


def test_slstm_bwd_plan(cuda):
    """The backward's geometry from the library for both instances: the
    forward's clusters and columns, a warp for each 32 rows of r (16 where
    a block has fewer rows than that a warp) and at least one for the gate
    threads, the shared memory of its buffers and ring; the card holds at
    least one cluster, and at dh 256 path 11's 4 heads in one wave."""
    import ctypes
    from repro_torch.kernels.slstm import HEAD_DIMS
    for dh in HEAD_DIMS:
        for code, elem in ((0, 4), (1, 2)):
            fwd = (ctypes.c_int * 20)()
            assert build.library().slstm_plan(dh, code, fwd) == 0
            plan = (ctypes.c_int * 16)()
            assert build.library().slstm_bwd_plan(dh, code, plan) == 0
            for n, (cs, cols, threads, rows, regs, smem, blocks,
                    clusters), f in ((fwd[8], plan[:8], fwd[:2]),
                                     (1, plan[8:], fwd[12:14])):
                assert (cs, cols) == tuple(f) and cs * cols == dh
                assert threads % 32 == 0 and n * cols <= threads
                assert rows * threads // 32 == dh and rows in (16, 32)
                assert smem == 16 + 4 * (2 * n * dh + 2 * n * 4 * cols
                                         + 4 * n * 7 * cols) + elem * 4 * n \
                    * cols
                assert regs > 0 and blocks >= 1 and clusters >= 1
            if dh == 256:
                assert 4 <= plan[15]
    plan = (ctypes.c_int * 16)()
    assert build.library().slstm_bwd_plan(48, 0, plan) != 0


def test_slstm_bwd_raises_on_what_it_does_not_take(cuda):
    """CPU tensors, a wrong dtype, a head dim with no instance, a record
    of the wrong shape or type and a mismatched cotangent raise."""
    args = slstm_inputs(2, 8, 4, 16, torch.float32, cuda)
    _, _, saved = slstm_saving(args)
    dhs, dfin = slstm_cotangents(2, 8, 4, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        slstm_bwd(saved.cpu(), args[2].cpu(), dhs.cpu())
    with pytest.raises(TypeError):
        slstm_bwd(saved, args[2], dhs.half())
    with pytest.raises(ValueError, match="head dim 48"):
        slstm_bwd(saved, torch.empty(4, 2, 48, 48, device=cuda), dhs)
    with pytest.raises(ValueError, match="saved must be"):
        slstm_bwd(saved[:, :4], args[2], dhs)
    with pytest.raises(ValueError, match="saved must be"):
        slstm_bwd(saved.double(), args[2], dhs)
    with pytest.raises(ValueError, match="dn must be"):
        slstm_bwd(saved, args[2], dhs, [None, dfin[1][:1], None, None])


@pytest.mark.parametrize("algorithm", ["mu_splitfed", "gas"])
def test_xlstm_round_card_matches_cpu(cuda, algorithm):
    """One small f32 round of xlstm-350m SMOKE widened by
    card_smoke_config (d_model 128: mLSTM heads of 64, sLSTM heads of 32),
    counter noise and seed replay (GAS with a stale client), on the card
    against the CPU: parameters, metrics and GAS's buffer within 1e-4; the
    card's round launches the sLSTM kernel."""
    from repro_torch.configs import SFLConfig, card_smoke_config
    from repro_torch.core import prng
    from repro_torch.core.baselines import gas_init_state, gas_round
    from repro_torch.core.splitfed import mu_splitfed_round
    from repro_torch.models import init_params, untie_params
    from repro_torch.utils import tree
    cfg = card_smoke_config("xlstm-350m")
    params = untie_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 64))
    sfl = SFLConfig(n_clients=2, tau=2, n_perturbations=2, cut_units=2,
                    perturbation_dist="counter")
    outs = []
    for d in ("cpu", cuda):
        b = {"tokens": torch.from_numpy(toks).to(d),
             "labels": torch.from_numpy(np.roll(toks, -1, -1)).to(d)}
        p = tree.tree_map(lambda a: a.to(d), params)
        before = build.LAUNCHES["slstm"]
        extra = []
        if algorithm == "gas":
            st = gas_init_state(cfg, sfl, p, b)
            p, st, m = gas_round(cfg, sfl, p, st, b,
                                 torch.tensor([1.0, 0.0], device=d),
                                 prng.PRNGKey(3), aggregation="seed_replay")
            extra = [*st.h_buffer.values()]
        else:
            p, m = mu_splitfed_round(cfg, sfl, p, b,
                                     torch.tensor([1.0, 0.5], device=d),
                                     prng.PRNGKey(3),
                                     aggregation="seed_replay")
        outs.append((tree.leaves(p), m, extra,
                     build.LAUNCHES["slstm"] - before))
    (p0, m0, e0, _), (p1, m1, e1, n) = outs
    assert n > 0
    for a, b in zip(p1, p0):
        assert float((a.cpu().float() - b.float()).abs().max()) <= 1e-4
    for f in m0._fields:
        assert float((getattr(m1, f).cpu() - getattr(m0, f)).abs().max()) \
            <= 1e-4
    for a, b in zip(e1, e0):
        assert float((a.cpu() - b).abs().max()) <= 1e-4


def test_xlstm_serving_card_matches_cpu(cuda):
    """xlstm-350m SMOKE widened by card_smoke_config, f32: serve.generate
    of 8 greedy tokens after a 40-token prompt (the mLSTM's chunks of 16
    and its tail) on the card against the CPU, tokens equal and the full
    forward over prompt and tokens within 1e-4 of max(|logits|, 1); the
    card's request launches slstm once a unit in the prefill and in every
    decode step, and rmsnorm."""
    from repro_torch.configs import card_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params, logits_fn
    from repro_torch.utils import tree
    cfg = card_smoke_config("xlstm-350m")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    outs = []
    for d in ("cpu", cuda):
        p = tree.tree_map(lambda a: a.to(d), params)
        before = dict(build.LAUNCHES)
        out = serve.generate(cfg, p, {"tokens": toks.to(d)}, 40, 8)
        n = {k: build.LAUNCHES[k] - before.get(k, 0)
             for k in ("slstm", "rmsnorm")}
        with torch.inference_mode():
            full = logits_fn(cfg, p, {"tokens": torch.cat([toks.to(d), out],
                                                          1)})
        outs.append((out.cpu(), full.cpu(), n))
    (t0, l0, _), (t1, l1, n) = outs
    assert torch.equal(t0, t1)
    assert float((l1 - l0).abs().max()) <= \
        1e-4 * max(float(l0.abs().max()), 1.0)
    # the prefill's and the 8 decode steps' launches (generate steps once
    # a token, the last one's logits unused), one a unit each
    assert n["slstm"] == cfg.n_units * 9 and n["rmsnorm"] > 0
