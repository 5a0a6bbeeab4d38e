"""Port parity: the gradient of MLA attention, and FedAvg on an MLA model,
against the JAX package on the CPU, on deepseek-v2-236b SMOKE (4 layers,
d_model 64, 4 heads of 16 nope + 8 rope dims and v 16, so (d_qk, d_v) =
(24, 16); kv_lora 16, q_lora 24, 8 experts top-2, 1 shared), f32, with
the reference's parameters carried across by the converter:
``ref.flash_attention_bwd_ref`` at d_v != d_qk (what the CPU runs in the
flash backward kernel's place), the autograd gradients of one
``mla_attention`` call, one ``fedavg_round`` with SGD and with AdamW, and
the driver's ``--algorithm fedavg``.

Tolerances. The plain backward against ``jax.vjp`` of the reference's MLA
core (its nope and rope score einsums, softmax, P·V) within 1e-6 of each
gradient's largest magnitude (sums in another order). ``mla_attention``'s
gradients, the input's and every core leaf's (wq_a, q_norm, wq_b, wkv_a,
kv_norm, wkv_b, wo), against ``jax.grad`` of
``repro.models.attention.mla_attention`` within 1e-5 of each leaf's
largest magnitude (the flash function scores over the 24 dims in one sum
where the reference adds two). The FedAvg rounds (M=3 clients, one masked,
η_g 0.3; the MoE routing, its aux loss and the shared expert inside) and
the driver's round within 1e-5 of the reference's, as
tests/test_torch_fo.py's TOL; the AdamW round within ADAMW_TOL = 2e-4,
measured 1.04e-4: one routed expert's weight (layer 2, expert 7 of
``wg``) has a gradient on the third client of -4.9e-9 here and +6.4e-9 in
the reference, rounding level in a leaf whose largest is 0.127 (the
gradients agree within 2.1e-6 of it), and AdamW's first step
lr·g/(|g| + 1e-8) turns that into 0.72·lr, times the client's weight 1/2
and η_g 0.3. One reference compile per function and shape: the jitted
round takes the learning rate and η_g as arguments.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.core import baselines as jbaselines
from repro.models import init_params as j_init
from repro.models import untie_params as j_untie
from repro.models.attention import mla_attention as j_mla_attention
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import baselines as tbaselines
from repro_torch.kernels import ref
from repro_torch.launch import train as t_train
from repro_torch.models import attention
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

ARCH = "deepseek-v2-236b"
TOL = 1e-5
ADAMW_TOL = 2e-4
M, B, S = 3, 2, 16


@functools.lru_cache(maxsize=None)
def _model():
    """(reference config, port config, reference params, port params), f32
    SMOKE, made once."""
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype="float32")
    tcfg = t_get_config(ARCH, smoke=True).replace(dtype="float32")
    jp = j_untie(jcfg, jax.jit(functools.partial(j_init, jcfg))(
        jax.random.PRNGKey(0)))
    return jcfg, tcfg, jp, from_jax_params(jp)


@functools.lru_cache(maxsize=None)
def _j_round(optimizer):
    """The reference's fedavg_round, jitted once an optimizer, with the
    learning rate and η_g as arguments."""
    jcfg = _model()[0]
    return jax.jit(lambda p, b, m, lr, eta: jbaselines.fedavg_round(
        jcfg, p, b, m, lr, 1, optimizer, eta_g=eta))


def _batches(seed=1):
    toks = np.random.default_rng(seed).integers(0, 256, (M, B, S))
    labels = np.roll(toks, -1, -1)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _maxdiff(t_tree, j_tree) -> float:
    got = tree.leaves(to_jax_params(t_tree))
    want = jax.tree.leaves(j_tree)
    assert len(got) == len(want)
    return max(float(np.abs(np.asarray(a, np.float32)
                            - np.asarray(b, np.float32)).max())
               for a, b in zip(got, want))


def _mla_core(q, k, v, causal):
    """The reference's MLA attention core (repro.models.attention.
    mla_attention's scores, mask, softmax and P·V) on (B, H, S, ·)
    operands, q and k split at their nope width like the reference's two
    score einsums (nope 16 of 24 here)."""
    nope = 16
    q, k, v = (a.swapaxes(1, 2) for a in (q, k, v))
    scores = (jnp.einsum("bshd,bthd->bhst", q[..., :nope], k[..., :nope],
                         preferred_element_type=jnp.float32)
              + jnp.einsum("bshd,bthd->bhst", q[..., nope:], k[..., nope:],
                           preferred_element_type=jnp.float32)
              ) * (1.0 / jnp.sqrt(24.0).astype(jnp.float32))
    if causal:
        n = q.shape[1]
        scores = scores + jnp.where(jnp.tril(jnp.ones((n, n), bool)), 0.0,
                                    -1e30)
    return jnp.einsum("bhst,bthd->bhsd", jax.nn.softmax(scores, -1), v)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_ref_at_the_mla_pair_matches_the_mla_core(causal):
    """flash_attention_bwd_ref at (d_qk, d_v) = (24, 16), H = Hkv = 4, on
    the plain forward's o and lse, against jax.vjp of the reference's MLA
    core: dq, dk (24 wide) and dv (16 wide) within 1e-6 of each one's
    largest magnitude."""
    rng = np.random.default_rng(4)
    q, k = (rng.standard_normal((B, 4, S, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, 4, S, 16)).astype(np.float32)
    do = rng.standard_normal((B, 4, S, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _mla_core(*a, causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal, 0, return_lse=True)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal, 0)
    assert [tuple(g.shape) for g in got] == [(B, 4, S, 24), (B, 4, S, 24),
                                             (B, 4, S, 16)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max()


def test_mla_attention_gradients_match_jax_grad():
    """The port's autograd gradients of sum(mla_attention(x)·r), the first
    layer's core at (2, 16, 64) inputs, against jax.grad of the
    reference's: the input's and each core leaf's within 1e-5 of its
    largest magnitude; every leaf's gradient is nonzero."""
    jcfg, tcfg, jp, tp = _model()
    jcore = jax.tree.map(lambda a: a[0], jp["units"]["b0"]["core"])
    names = sorted(jcore)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    r = rng.standard_normal((B, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = jax.jit(jax.grad(lambda c, xx: jnp.sum(j_mla_attention(
        jcfg, c, xx, jnp.asarray(pos)) * r), argnums=(0, 1)))(
        jcore, jnp.asarray(x))
    leaves = {n: tp["units"]["b0"]["core"][n][0].clone().requires_grad_()
              for n in names}
    tx = torch.from_numpy(x).requires_grad_()
    y = attention.mla_attention(tcfg, leaves, tx, torch.from_numpy(
        pos.copy()))
    got = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                              [tx] + [leaves[n] for n in names])
    for name, g, w in zip(["x"] + names, got,
                          [want[1]] + [want[0][n] for n in names]):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


@pytest.mark.parametrize("optimizer,lr,tol", [("sgd", 1e-2, TOL),
                                              ("adamw", 1e-3, ADAMW_TOL)])
def test_fedavg_round_on_mla_matches_reference(optimizer, lr, tol):
    """One FedAvg round (E=1) of M=3 clients, the second masked (it trains
    and weighs 0), η_g 0.3, on deepseek SMOKE against the reference's
    jitted round: every leaf within TOL (AdamW: ADAMW_TOL), and the
    parameters moved."""
    jcfg, tcfg, jp, tp = _model()
    jb, tb = _batches()
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    want = _j_round(optimizer)(jp, jb, jnp.asarray(mask), lr, 0.3)
    got = tbaselines.fedavg_round(tcfg, tp, tb, torch.from_numpy(mask), lr,
                                  1, optimizer, eta_g=0.3)
    assert _maxdiff(got, want) <= tol
    assert _maxdiff(got, jp) > 0


def test_driver_runs_fedavg_on_mla_on_cpu():
    """``launch.train --arch deepseek-v2-236b --smoke --device cpu
    --algorithm fedavg`` (the f32 SMOKE config passed as ``cfg``), M=3,
    batch 2, seq 16, one round at full participation: a finite loss, and
    the round's parameters within TOL of the reference's fedavg_round on
    the driver's own initial parameters, batch and defaults (SGD at
    lr_client, η_g = lr_global)."""
    tcfg = _model()[1]
    run = t_train.setup(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--clients", str(M), "--batch", str(B), "--seq",
                         str(S), "--rounds", "1", "--algorithm", "fedavg"],
                        cfg=tcfg)
    init = to_jax_params(run.params)
    batch = run.loader.round_batch(0)
    res, _ = t_train.run_engine(run, log=None)
    assert np.isfinite(res.round_loss).all()
    want = _j_round("sgd")(init, {k: jnp.asarray(v, jnp.int32)
                                  for k, v in batch.items()},
                           jnp.ones(M, jnp.float32), run.sfl.lr_client,
                           run.sfl.lr_global)
    assert _maxdiff(res.params, want) <= TOL
    assert _maxdiff(res.params, init) > 0
