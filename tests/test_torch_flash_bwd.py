"""The bf16 flash backward kernels' rounding (``csrc/flash_attention_bwd.cu``),
emulated in plain torch on the CPU, where the kernels cannot run
(``tests/flash_bwd_emulation.py``: the kernels' tiles, loop bounds and
column steps, P and dS rounded to bf16 once or split into hi + lo as the
kernels round them, ``KERNEL_SPLIT``). The emulation is held against the
port's plain backward (``ref.flash_attention_bwd_ref``) and ``jax.vjp`` of
the reference's einsum attention (``repro.models.attention.gqa_attention``
with identity projections at position 0, where RoPE is the identity; at
MLA's head dims (d_qk, d_v) = (192, 128) the einsum core of
``repro.models.attention.mla_attention``: nope and rope score einsums in
f32, softmax, P·V) at small shapes.

Tolerance: the card's (chip_smoke.check_grad, tests/test_torch_gpu.py), each
bf16 gradient within 2^-7·max|g| of the reference's.

    python tests/test_torch_flash_bwd.py [N]

prints the emulation's margins at the card's shapes (chip_smoke.py's
phase_flash_bwd cases, MLA's at S = 512) for one cast, the kernels' choice
and the split, and the worst of N random small cases (default 200), the
(192, 128) pair among them.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_bwd_emulation import (KERNEL_SPLIT, dkdv_walk, dq_walk,
                                 emulate_bf16_flash_bwd_kernel, inputs, kn,
                                 qn, worst)
from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.models import attention as j_attention
from repro_torch.kernels import ref


def _einsum_vjp(q, k, v, do, causal, window):
    """dq, dk, dv (f32 numpy) by jax.vjp of the reference's gqa_attention
    on x = [q | k | v] with identity projections, at position 0."""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    cfg = j_get_config("olmo-1b", smoke=True).replace(
        d_model=(H + 2 * Hkv) * d, n_heads=H, n_kv_heads=Hkv, d_head=d,
        dtype="float32", sliding_window=window, qk_norm=False)
    D = cfg.d_model
    eye = np.eye(D, dtype=np.float32)
    cut = np.cumsum([0, H * d, Hkv * d, Hkv * d])
    p = {"wq": eye[:, cut[0]:cut[1]], "wk": eye[:, cut[1]:cut[2]],
         "wv": eye[:, cut[2]:cut[3]], "wo": np.eye(H * d, dtype=np.float32)}
    p = {n: jnp.asarray(w) for n, w in p.items()}

    def bsd(t):   # (B, heads, S, d) -> (B, S, heads·d)
        t = t.float().numpy()
        return t.transpose(0, 2, 1, 3).reshape(B, S, -1)
    x = jnp.asarray(np.concatenate([bsd(q), bsd(k), bsd(v)], -1))
    pos = jnp.zeros((B, S), jnp.int32)
    _, vjp = jax.vjp(lambda xx: j_attention.gqa_attention(
        cfg, p, xx, pos, causal=causal), x)
    (dx,) = vjp(jnp.asarray(bsd(do)))
    dx = np.asarray(dx)

    def heads(a, n):
        return a.reshape(B, S, n, d).transpose(0, 2, 1, 3)
    return (heads(dx[..., cut[0]:cut[1]], H),
            heads(dx[..., cut[1]:cut[2]], Hkv),
            heads(dx[..., cut[2]:cut[3]], Hkv))


def _mla_core_vjp(q, k, v, do, causal):
    """dq, dk, dv (f32 numpy) by jax.vjp of the reference's MLA core (as in
    ``repro.models.attention.mla_attention``: the nope and rope score
    einsums in f32 with preferred_element_type, scaled by 1/√d_qk, masked,
    softmax, P·V), each head's k and v repeated over its group (MLA has
    H = Hkv; the kernels take G > 1 too)."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    nope = d - 64

    def core(q_, k_, v_):
        q_, k_, v_ = (a.swapaxes(1, 2) for a in (q_, jnp.repeat(k_, G, 1),
                                                  jnp.repeat(v_, G, 1)))
        scores = (jnp.einsum("bshd,bthd->bhst", q_[..., :nope],
                             k_[..., :nope],
                             preferred_element_type=jnp.float32)
                  + jnp.einsum("bshd,bthd->bhst", q_[..., nope:],
                               k_[..., nope:],
                               preferred_element_type=jnp.float32)
                  ) * (1.0 / jnp.sqrt(float(d)).astype(jnp.float32))
        if causal:
            scores = scores + jnp.where(jnp.tril(jnp.ones((S, S), bool)),
                                        0.0, -1e30)
        return jnp.einsum("bhst,bthd->bhsd", jax.nn.softmax(scores, -1), v_)
    args = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    _, vjp = jax.vjp(core, *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(do.float().numpy()))]


def _flash_pairs(S, causal, window):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.flash_pairs(S, causal, window)


# (B, H, Hkv, S, d, causal, window), d or MLA's (d_qk, d_v): G 1, 2, 4
# and 5, d 64 and 128 and (192, 128), causal, causal with a window, a
# window alone, not causal, S ragged and below one tile
MLA = (192, 128)
CASES = [(1, 2, 2, 128, 64, True, 0),
         (1, 4, 1, 100, 128, True, 0),
         (1, 5, 1, 130, 128, True, 40),
         (2, 5, 1, 64, 64, True, 0),
         (1, 4, 1, 150, 64, False, 50),
         (1, 2, 2, 40, 128, True, 0),
         (1, 2, 2, 100, MLA, True, 0),
         (1, 4, 2, 70, MLA, False, 0)]


def _d(c):
    return f"{c[0]}x{c[1]}" if isinstance(c, tuple) else str(c)


IDS = [f"G{c[1] // c[2]}-d{_d(c[4])}-S{c[3]}-"
       f"{'causal' if c[5] else 'noncausal'}-w{c[6]}" for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_bwd_kernel_rounding_is_within_the_tolerance(case):
    """The bf16 kernels' rounding (emulated, split as the kernels split)
    against the plain backward and jax.vjp of the reference's einsum
    attention (MLA's core at (192, 128)): each gradient within
    2^-7·max|g|."""
    causal, window = case[5], case[6]
    q, k, v, o, lse, do = inputs(case)
    got = emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, causal, window,
                                        **KERNEL_SPLIT)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert got[2].shape == v.shape
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window)
    einsum = (_mla_core_vjp(q, k, v, do, causal) if q.shape[-1] == 192
              else _einsum_vjp(q, k, v, do, causal, window))
    assert worst(got, plain) <= 1.0
    assert worst(got, einsum) <= 1.0
    # every operand split into hi + lo meets the plain version too
    split = emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, causal,
                                          window, True, True)
    assert worst(split, plain) <= 1.0


def test_flash_bwd_dq_rounding_needs_the_ds_split():
    """Why the dQ kernel splits dS: on these fixed inputs (the one of 12,000
    random small cases of ``margins`` where it happens) dS cast to bf16
    once moves dQ by more than 2^-7·max|dQ| from the plain backward, which
    the hi + lo split does not; P and dK's dS cast once stay within."""
    case = (1, 4, 2, 100, 64, True, 30)
    q, k, v, o, lse, do = inputs(case, seed=3790)
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True, 30)
    one_cast = emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, True, 30)
    kernel = emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, True, 30,
                                           **KERNEL_SPLIT)
    assert worst(one_cast[:1], plain[:1]) > 1.0
    assert worst(kernel[:1], plain[:1]) <= 1.0
    assert worst(one_cast[1:], plain[1:]) <= 1.0
    assert all(torch.equal(a, b) for a, b in zip(one_cast[1:], kernel[1:]))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_bwd_kernel_walks_cover_every_pair_once(case):
    """The dK/dV and dQ kernels' loop bounds (the tiles the emulation walks,
    in steps of ``qn`` query columns and ``kn`` keys) meet every unmasked
    (query, key) pair exactly once and no masked one: as many as
    chip_smoke.flash_pairs counts."""
    B, H, Hkv, S, d, causal, window = case
    cov = {}
    emulate_bf16_flash_bwd_kernel(*inputs(case), causal, window,
                                  coverage=cov)
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= i - j < window
    for walk in ("dkdv", "dq"):
        assert torch.equal(cov[walk], ok.long().expand(B, H, S, S))
        assert int(cov[walk].sum()) == B * H * _flash_pairs(S, causal,
                                                            window)
    assert (qn(64), qn(128), qn(192)) == (64, 32, 32)
    assert (kn(64, 64), kn(128, 128), kn(192, 128)) == (64, 32, 16)
    assert len(list(dkdv_walk(S, causal, window))) == \
        len(list(dq_walk(S, causal, window))) == -(-S // 64)


def margins(n_random: int = 200) -> None:
    """Print the emulation's margins over the tolerance (max|Δ| over
    2^-7·max|g|, for dq, dk and dv): at the card's shapes, one cast's f32
    error before the final rounding (against the split, f32 to within its
    sum order), and after it against the plain backward for one cast, the
    kernels' choice and the split; then the worst of each over n_random
    random small cases (seeds 1000 + i), a fifth of them at (192, 128)."""
    variants = {"one cast": dict(split_p=False, split_ds=False),
                "kernels' choice": KERNEL_SPLIT,
                "hi + lo": dict(split_p=True, split_ds=True)}
    card = [(1, 32, 32, 512, 64, True, 0), (1, 40, 8, 512, 128, True, 0),
            (1, 40, 8, 512, 128, True, 128), (1, 4, 4, 300, 64, False, 70),
            (1, 16, 16, 512, MLA, True, 0)]
    for case in card:
        q, k, v, o, lse, do = inputs(case)
        causal, window = case[5], case[6]
        plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                            window)
        f32 = [emulate_bf16_flash_bwd_kernel(
            q, k, v, o, lse, do, causal, window, split, split,
            out=torch.float32) for split in (False, True)]
        print(f"{case} one cast, before rounding: " + " ".join(
            f"{worst([g], [w]):.3f}" for g, w in zip(*f32)))
        for name, kw in variants.items():
            got = emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, causal,
                                                window, **kw)
            print(f"{case} {name}, after rounding: " + " ".join(
                f"{worst([g], [w]):.3f}" for g, w in zip(got, plain)))
    shapes = [(1, 4, 4, 64, 64, True, 0), (1, 5, 1, 64, 128, True, 0),
              (1, 4, 2, 100, 64, True, 30), (1, 2, 2, 70, 64, False, 20),
              (1, 2, 2, 100, MLA, True, 0)]
    worst_of = {(name, mla): [0.0] * 3 for name in variants
                for mla in (False, True)}
    for seed in range(n_random):
        case = shapes[seed % len(shapes)]
        q, k, v, o, lse, do = inputs(case, seed=1000 + seed)
        plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, case[5],
                                            case[6])
        for name, kw in variants.items():
            got = emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do,
                                                case[5], case[6], **kw)
            key = (name, case[4] == MLA)
            worst_of[key] = [max(a, worst([g], [w])) for a, g, w in
                             zip(worst_of[key], got, plain)]
    for (name, mla), w in worst_of.items():
        print(f"{n_random} random cases{' at (192, 128)' if mla else ''}, "
              f"{name}: worst dq dk dv " + " ".join(f"{x:.3f}" for x in w))


if __name__ == "__main__":
    margins(int(sys.argv[1]) if len(sys.argv) > 1 else 200)
