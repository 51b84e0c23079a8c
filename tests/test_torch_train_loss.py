"""The dense decoders' training loss against the JAX reference, on the CPU.

* ``chunked_xent`` against the reference's on the same numpy inputs: a
  ragged S of 19, with and without a loss mask, chunks below, at and
  above S (rtol 1e-6: float32 logits, another summation order).
* ``Model.loss`` and the gradient of every parameter against ``jax.grad``
  of the reference's ``Model.loss`` on the same weights
  (``model_params_from_jax``) and batch, in float32, matched by parameter
  path (the reference's gradient tree goes through the same converter):
  the loss at rtol 1e-5, each gradient at rtol 1e-4 with an absolute
  floor of 1e-5 x its largest entry (two frameworks' float32 matmuls and
  softmaxes in other summation orders, through two layers and back: the
  near-zero entries of a gradient carry the cancellation error of its
  large ones).  Configurations: the reduced qwen2-7b with 2 KV heads (GQA,
  qkv bias, an unembedding) and command-r-plus-104b (tied embeddings).
* ``remat`` on against off: the same loss and gradients, bitwise.
* K8's backward, ``flash_attention_backward_plain``, against autograd of
  the plain forward (rtol 1e-5) and against ``jax.grad`` of the
  reference's ``_flash`` (rtol 1e-4), causal and bidirectional, with
  1, 2 and 4 KV heads of 4 query heads at a ragged S of 19.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch import configs as tcfgs
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from test_torch_models import _perturbed_tree, _reduced

S, BATCH, LOSS_CHUNK = 19, 2, 8
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5


def _mask(rng, shape):
    m = (rng.random(shape) < 0.7).astype(np.float32)
    m[:, 0] = 1.0
    return m


@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
@pytest.mark.parametrize("chunk", [4, 8, 19, 64])
def test_chunked_xent_matches_reference(chunk, masked):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((BATCH, S, 32)).astype(np.float32)
    emb = (0.3 * rng.standard_normal((50, 32))).astype(np.float32)
    labels = rng.integers(0, 50, (BATCH, S), dtype=np.int32)
    mask = _mask(rng, (BATCH, S)) if masked else None
    want = jcommon.chunked_xent(jnp.asarray(h), jnp.asarray(emb),
                                jnp.asarray(labels), chunk=chunk,
                                mask=None if mask is None else jnp.asarray(mask))
    got = tcommon.chunked_xent(torch.from_numpy(h), torch.from_numpy(emb),
                               torch.from_numpy(labels), chunk=chunk,
                               mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


LOSS_CONFIGS = {"qwen2-7b kv2": ("qwen2-7b", 2),
                "command-r-plus-104b": ("command-r-plus-104b", None)}


@pytest.fixture(scope="module", params=list(LOSS_CONFIGS))
def loss_run(request):
    """The loss and every gradient in both packages, and the port's with
    remat on and off."""
    arch, kv = LOSS_CONFIGS[request.param]
    jcfg, tcfg = _reduced(jcfgs, arch, kv), _reduced(tcfgs, arch, kv)
    tree = _perturbed_tree(japi.build_model(jcfg).init(jax.random.PRNGKey(0)), 7)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (BATCH, S), dtype=np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (BATCH, S), dtype=np.int32),
             "loss_mask": _mask(rng, (BATCH, S))}
    jmodel = japi.build_model(jcfg, remat=False, loss_chunk=LOSS_CHUNK,
                              q_chunk=8, kv_chunk=8)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    want = dict(model_params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                                      device="cpu").named_parameters())
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {}
    for remat in (True, False):
        model = tapi.build_model(tcfg, device="cpu", remat=remat,
                                 loss_chunk=LOSS_CHUNK)
        params = model_params_from_jax(tree, tcfg, device="cpu")
        params.requires_grad_(True)
        loss = model.loss(params, tbatch)
        names, leaves = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        got[remat] = (loss.detach(), dict(zip(names, grads)))
    return dict(jloss=float(jloss), want=want, got=got)


def test_loss_matches_reference(loss_run):
    loss, _ = loss_run["got"][True]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), loss_run["jloss"], rtol=1e-5)


def test_every_gradient_matches_reference(loss_run):
    _, grads = loss_run["got"][True]
    want = loss_run["want"]
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].detach().numpy()
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_FLOOR * float(np.abs(w).max()),
                                   err_msg=name)


def test_remat_gives_the_same_bits(loss_run):
    (l_on, g_on), (l_off, g_off) = loss_run["got"][True], loss_run["got"][False]
    assert torch.equal(l_on, l_off)
    for name in g_on:
        assert torch.equal(g_on[name], g_off[name]), name


def test_loss_refuses_a_prefix_and_an_encoder_output():
    cfg = tcfgs.get_config("qwen2-7b").reduced()
    model = tapi.build_model(cfg, device="cpu")
    params = model.init(0)
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "labels": torch.zeros(1, 4, dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="prefix.*11.5"):
        model.loss(params, dict(batch, prefix_emb=torch.zeros(1, 2, cfg.d_model)))
    with pytest.raises(NotImplementedError, match="cross.*11.6"):
        model.loss(params, dict(batch, enc_out=torch.zeros(1, 2, cfg.d_model)))


FLASH_GRAD_CASES = [(causal, kv) for causal in (True, False) for kv in (1, 2, 4)]


@pytest.mark.parametrize("causal,kv", FLASH_GRAD_CASES,
                         ids=[f"{'causal' if c else 'bidir'}-kv{k}"
                              for c, k in FLASH_GRAD_CASES])
def test_flash_attention_backward_plain(causal, kv):
    rng = np.random.default_rng(kv + 10 * causal)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32) for s in
                     ((BATCH, S, 4, 16), (BATCH, S, kv, 16), (BATCH, S, kv, 16),
                      (BATCH, S, 4, 16)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention_plain(tq, tk, tv, causal)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    got = fa.flash_attention_backward_plain(
        tq.detach(), tk.detach(), tv.detach(), out.detach(),
        torch.from_numpy(dout), causal)

    def jflash(q, k, v):
        return jattn._flash(q, k, v, causal=causal, prefix_len=0, q_chunk=8,
                            kv_chunk=8)

    _, vjp = jax.vjp(jflash, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(dout))
    for name, g, a, r in zip("qkv", got, auto, ref):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"d{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name} vs reference")
