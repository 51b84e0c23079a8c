"""MoE routing and the sliding window against the JAX reference, on the CPU.

Inputs are made in numpy from a seed and handed to both packages.

* ``models.moe.moe`` against ``repro.models.moe.moe`` in float32, output
  and aux loss within 1e-5 (the experts' products and the combine sum in
  another order): a ragged token count that pads its last group, a
  capacity that drops pairs (asserted), shared experts on and off, gated
  (swiglu) and plain (gelu, squared_relu) experts, and the decode
  settings (capacity factor E, groups of max(B, 8)).
* Windowed attention: K8's plain version (through ``ops.flash_attention``
  on CPU tensors) against the reference's ``_sliding``, windows below,
  equal to and above S at a ragged S with GQA; its autograd and
  ``flash_attention_backward_plain`` against ``jax.vjp`` of ``_sliding``
  (rtol 1e-4 / atol 1e-5 as the dense backward's test; rtol and atol
  1e-5 between the two torch backwards: at window 1 each row's one
  probability is 1, dS = P (dP - rowsum(dO O)) cancels to 0 exactly in
  autograd and to a few 1e-7 of |dO| |V| in the plain backward).
* The reduced qwen2-moe-a2.7b and mixtral-8x22b (sliding window 64)
  against the reference after ``model_params_from_jax``: prefill over 96
  tokens (so the window bites), 3 decode steps (logits and every layer's
  cache), the training loss with its MoE aux term and every parameter's
  gradient.  Logits and caches at rtol 1e-4 / atol 1e-5, the loss at rtol
  1e-5, gradients at rtol 1e-4 with a floor of 1e-5 x the largest entry
  (tests/test_torch_models.py and test_torch_train_loss.py give why).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch import configs as tcfgs
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from test_torch_models import MODEL_TOL, _perturbed_tree

MOE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

# id -> (B, S, E, top_k, shared, activation, capacity_factor, group_size)
MOE_CASES = {
    "pad-swiglu": (2, 37, 8, 2, 0, "swiglu", 1.25, 16),
    "drop-gelu-shared": (2, 37, 8, 2, 1, "gelu", 0.5, 2048),
    "shared2-swiglu": (1, 50, 6, 3, 2, "swiglu", 1.0, 20),
    "plain-squared_relu": (2, 24, 4, 1, 0, "squared_relu", 1.25, 2048),
    "decode": (3, 1, 60, 4, 1, "swiglu", 60.0, 8),
}
D, F = 32, 48


def _moe_weights(rng, e, shared, activation):
    w = {"router": rng.standard_normal((D, e)),
         "w_in": rng.standard_normal((e, D, F)) * D ** -0.5,
         "w_gate": rng.standard_normal((e, D, F)) * D ** -0.5,
         "w_out": rng.standard_normal((e, F, D)) * F ** -0.5}
    w = {n: a.astype(np.float32) for n, a in w.items()}
    if shared:
        f = shared * F
        sh = {"w_in": rng.standard_normal((D, f)) * D ** -0.5,
              "w_out": rng.standard_normal((f, D)) * f ** -0.5}
        if activation in ("swiglu", "geglu"):
            sh["w_gate"] = rng.standard_normal((D, f)) * D ** -0.5
        w["shared"] = {n: a.astype(np.float32) for n, a in sh.items()}
    return w


def _tree(w, leaf):
    return {n: _tree(a, leaf) if isinstance(a, dict) else leaf(a)
            for n, a in w.items()}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(case):
    b, s, e, k, shared, act, cf, gs = MOE_CASES[case]
    rng = np.random.default_rng(len(case))
    w = _moe_weights(rng, e, shared, act)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    kw = dict(num_experts=e, top_k=k, activation=act, capacity_factor=cf,
              group_size=gs, num_shared_experts=shared)
    jy, jaux = jax.jit(functools.partial(jmoe.moe, **kw))(_tree(w, jnp.asarray),
                                                           jnp.asarray(x))
    y, aux = tmoe.moe(_tree(w, torch.from_numpy), torch.from_numpy(x), **kw)
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, s, D)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MOE_TOL)
    # The case exercises what its name says.
    t = b * s
    group = min(gs, t)
    cap = tmoe.capacity(group, k, e, cf)
    xf = torch.nn.functional.pad(torch.from_numpy(x).reshape(t, D),
                                 (0, 0, 0, (-t) % group))
    _, _, idx = tmoe.route((xf @ torch.from_numpy(w["router"])).reshape(
        -1, group, e), k)
    load = torch.nn.functional.one_hot(idx, e).sum(dim=(1, 2))   # (G, E)
    if case.startswith("pad"):
        assert t % group != 0
    if case.startswith("drop"):
        assert bool((load > cap).any())
    if case == "decode":   # no-drop settings: every pair keeps its slot
        assert bool((load <= cap).all())


def test_moe_top_k_takes_the_lower_expert_among_ties():
    probs_logits = torch.zeros(1, 3, 6)
    probs_logits[0, 1, 4] = 1.0
    _, gate, idx = tmoe.route(probs_logits, 3)
    assert idx[0, 0].tolist() == [0, 1, 2]
    assert idx[0, 1].tolist() == [4, 0, 1]
    torch.testing.assert_close(gate.sum(-1), torch.ones(1, 3))


# ---------------------------------------------------------------------------
# The sliding window through K8's plain version and its backward
# ---------------------------------------------------------------------------

WS, WH, WKV, WHD = 45, 4, 2, 16
WINDOWS = {"w1": 1, "w7": 7, "w44": 44, "eqS": WS, "gtS": 200}


@pytest.fixture(scope="module")
def window_inputs():
    rng = np.random.default_rng(21)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((2, WS, WH, WHD), (2, WS, WKV, WHD), (2, WS, WKV, WHD),
             (2, WS, WH, WHD))]


@pytest.mark.parametrize("window", list(WINDOWS))
def test_windowed_attention_matches_reference_sliding(window, window_inputs):
    w = WINDOWS[window]
    q, k, v, dout = window_inputs
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, window=w)

    def jslide(q, k, v):
        return jattn._sliding(q, k, v, window=w, q_chunk=16)

    @jax.jit
    def reference(q, k, v, dout):
        jout, vjp = jax.vjp(jslide, q, k, v)
        return jout, vjp(dout)

    jout, ref = reference(*(jnp.asarray(a) for a in (q, k, v, dout)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    plain = fa.flash_attention_backward_plain(
        tq.detach(), tk.detach(), tv.detach(), out.detach(),
        torch.from_numpy(dout), True, w)
    for name, g, a, r in zip("qkv", plain, auto, ref):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name} vs reference")
    if w >= WS:   # a window past every query is plain causal attention
        assert torch.equal(out, ops.flash_attention(tq, tk, tv, causal=True))


def test_window_pairs_and_checks():
    assert fa.window_pairs(10, None) == 55 == fa.window_pairs(10, 10)
    assert fa.window_pairs(10, 1) == 10
    assert fa.window_pairs(10, 4) == 10 + 6 * 4
    x = torch.zeros(1, 3, 2, 8)
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(x, x, x, causal=False, window=2)
    for bad in (0, -1, 2.0, True):
        with pytest.raises(ValueError, match="window"):
            ops.flash_attention(x, x, x, window=bad)


# ---------------------------------------------------------------------------
# Whole models: reduced qwen2-moe-a2.7b and mixtral-8x22b
# ---------------------------------------------------------------------------

MOE_ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b")
PROMPT, STEPS, BATCH = 96, 3, 2


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_run(request):
    """Prefill + decode, and the loss with every gradient, in both
    packages from the same weights."""
    arch = request.param
    jcfg, tcfg = jcfgs.get_config(arch).reduced(), tcfgs.get_config(arch).reduced()
    tree = _perturbed_tree(japi.build_model(jcfg).init(jax.random.PRNGKey(3)), 9)
    rng = np.random.default_rng(10)
    prompt = rng.integers(0, jcfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    steps = rng.integers(0, jcfg.vocab_size, (STEPS, BATCH, 1), dtype=np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    cap = PROMPT + STEPS
    jmodel = japi.build_model(jcfg, q_chunk=16, kv_chunk=16)
    jparams = jax.tree.map(jnp.asarray, tree)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(prompt)})
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, cap - PROMPT), (0, 0), (0, 0))),
        jcache)
    jdecode = jax.jit(jmodel.decode_step)
    want = {"prefill": np.asarray(jlogits)}
    for i, tok in enumerate(steps):
        lg, jcache = jdecode(jparams, jcache, jnp.asarray(tok), jnp.int32(PROMPT + i))
        want[f"decode {i}"] = np.asarray(lg)
    jbatch = {"tokens": jnp.asarray(prompt), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jbatch)

    model = tapi.build_model(tcfg, device="cpu")
    params = model_params_from_jax(tree, tcfg, device="cpu")
    cache = model.init_cache(BATCH, cap, dtype=torch.float32)
    got = {}
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)},
                                  cache=cache)
        got["prefill"] = lg.numpy()
        for i, tok in enumerate(steps):
            lg, cache = model.decode_step(params, cache, torch.from_numpy(tok),
                                          PROMPT + i)
            got[f"decode {i}"] = lg.numpy()
    params.requires_grad_(True)
    loss = model.loss(params, {"tokens": torch.from_numpy(prompt),
                               "labels": torch.from_numpy(labels)})
    names, leaves = zip(*params.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    wgrads = dict(model_params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                                        device="cpu").named_parameters())
    return dict(cfg=tcfg, got=got, want=want, cache=cache, jcache=jcache,
                loss=loss.detach(), jloss=float(jloss), grads=grads,
                wgrads=wgrads)


def test_moe_model_logits_match_reference(moe_run):
    cfg = moe_run["cfg"]
    assert cfg.family == "moe" and PROMPT > (cfg.sliding_window or 0)
    got, want = moe_run["got"], moe_run["want"]
    assert list(got) == ["prefill"] + [f"decode {i}" for i in range(STEPS)]
    for name in got:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **MODEL_TOL)


def test_moe_model_cache_matches_reference(moe_run):
    cache, jcache = moe_run["cache"], moe_run["jcache"]
    for pos, sub in jcache.items():
        for name, want in sub.items():
            np.testing.assert_allclose(cache[pos][name].numpy(), np.asarray(want),
                                       err_msg=f"{pos}.{name}", **MODEL_TOL)


def test_moe_model_loss_and_gradients_match_reference(moe_run):
    np.testing.assert_allclose(float(moe_run["loss"]), moe_run["jloss"], rtol=1e-5)
    grads, want = moe_run["grads"], moe_run["wgrads"]
    assert set(grads) == set(want)
    assert any(".moe.router" in n for n in grads)
    for name, g in grads.items():
        w = want[name].detach().numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_FLOOR * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_runs_moe_on_the_cpu(arch, capsys):
    """``launch/serve.py --arch <moe> --reduced --device cpu`` with a prompt
    past the reduced window of 64."""
    from repro_torch.launch import serve
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--prompt-len", "70", "--decode-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "prefill 70 tokens" in out and "tok/s" in out
    assert tuple(res["tokens"].shape) == (2, 3)
    assert bool(torch.isfinite(res["logits"]).all())
