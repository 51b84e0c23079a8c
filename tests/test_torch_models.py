"""The port's dense-decoder serving path against the JAX reference, on the CPU.

Inputs are made in numpy from a seed and handed to both packages.  The
modules (norms, RoPE, MLP, attention) are held at rtol/atol 1e-6 in float32
(only the summation order differs) and 2e-2 in bfloat16 (the two
frameworks round at other places).  K8's plain version is held against the
reference's Pallas kernel in interpret mode (``repro.kernels.ops``, as
``tests/test_kernels.py`` runs it) and its ``ref.flash_attention`` at that
file's shapes and tolerances (2e-5 in float32, 2e-2 in bfloat16).

Whole prefill + 4 decode steps are held against the reference's
``build_model(cfg).prefill``/``decode_step`` after ``model_params_from_jax``,
logits and every layer's cache, at rtol 1e-4 / atol 1e-5 in float32: two
layers of float32 matmuls, softmaxes and norms in another summation order
(XLA's and PyTorch's CPU kernels) drift by a few 1e-6 relative, and the
reference's attention tiles its online softmax in 16-key chunks where the
port's plain version takes one softmax.  Configurations: the reduced
qwen2-7b with 4, 2 and 1 KV heads (GQA and MQA) and a ragged prompt of 37,
and the reduced mistral-large-123b, command-r-plus-104b (tied embeddings,
no bias) and nemotron-4-340b (squared-ReLU, no gate).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtfm
from repro_torch import configs as tcfgs
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttfm

F32 = dict(rtol=1e-6, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
PROMPT, DECODE_STEPS, BATCH = 37, 4, 2


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.array(x, np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


DTYPES = {"f32": (torch.float32, jnp.float32, F32),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16)}


# ---------------------------------------------------------------------------
# Config registry
# ---------------------------------------------------------------------------

def test_registry_names_mirror_the_reference():
    assert tcfgs.ARCH_NAMES == jcfgs.ARCH_NAMES
    assert set(tcfgs.SHAPES) == set(jcfgs.SHAPES)
    for name, shape in tcfgs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jcfgs.SHAPES[name])
    assert dataclasses.asdict(tcfgs.TrainConfig()) == dataclasses.asdict(
        jcfgs.TrainConfig())
    assert dataclasses.asdict(tcfgs.LOGREG_CONFIG) == dataclasses.asdict(
        jcfgs.LOGREG_CONFIG)
    with pytest.raises(KeyError, match="unknown arch"):
        tcfgs.get_config("nope")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", jcfgs.ARCH_NAMES)
def test_config_fields_match_the_reference(arch, reduced):
    port, want = tcfgs.get_config(arch), jcfgs.get_config(arch)
    if reduced:
        port, want = port.reduced(), want.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(want)
    assert port.resolved_head_dim == want.resolved_head_dim
    assert port.d_inner == want.d_inner and port.ssm_heads == want.ssm_heads
    assert str(port.dtype) == f"torch.{want.dtype}"
    (pat_p, per_p), (pat_w, per_w) = port.resolve_pattern(), want.resolve_pattern()
    assert per_p == per_w
    assert [dataclasses.asdict(b) for b in pat_p] == [
        dataclasses.asdict(b) for b in pat_w]


def test_qwen2_7b_parameter_count():
    """7,615,616,512 parameters (15.23 GB in bf16), the served model."""
    model = ttfm.decoder_params(
        lambda path, shape, init=None: torch.nn.Parameter(
            torch.empty(tuple(shape), device="meta"), requires_grad=False),
        tcfgs.get_config("qwen2-7b"))
    assert sum(p.numel() for p in model.parameters()) == 7_615_616_512
    assert len(model.blocks) == 28


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
def test_norms_match_reference(dt):
    tdt, jdt, tol = DTYPES[dt]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 96)) * 3 + 0.5
    scale = 1 + 0.1 * rng.standard_normal(96)
    bias = 0.1 * rng.standard_normal(96)
    np.testing.assert_allclose(
        _np(tcommon.rmsnorm(_t(x, tdt), _t(scale, tdt))),
        _np(jcommon.rmsnorm(_j(x, jdt), _j(scale, jdt))), **tol)
    np.testing.assert_allclose(
        _np(tcommon.layernorm(_t(x, tdt), _t(scale, tdt), _t(bias, tdt))),
        _np(jcommon.layernorm(_j(x, jdt), _j(scale, jdt), _j(bias, jdt))), **tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dt", DTYPES)
def test_apply_rope_matches_reference(dt, theta):
    tdt, jdt, tol = DTYPES[dt]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 3, 64))
    pos = np.broadcast_to(np.arange(37, dtype=np.int32), (2, 37))
    got = tcommon.apply_rope(_t(x, tdt), torch.from_numpy(pos.copy()), theta)
    assert got.dtype == tdt
    np.testing.assert_allclose(
        _np(got), _np(jcommon.apply_rope(_j(x, jdt), jnp.asarray(pos), theta)), **tol)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "squared_relu", "gelu"])
@pytest.mark.parametrize("dt", DTYPES)
def test_mlp_matches_reference(dt, activation):
    tdt, jdt, tol = DTYPES[dt]
    rng = np.random.default_rng(2)
    d, f = 32, 48
    w = {"w_in": rng.standard_normal((d, f)) * d ** -0.5,
         "w_out": rng.standard_normal((f, d)) * f ** -0.5,
         "w_gate": rng.standard_normal((d, f)) * d ** -0.5}
    if activation not in jmlp.GATED:
        del w["w_gate"]
    x = rng.standard_normal((2, 7, d))
    got = tmlp.mlp({k: _t(v, tdt) for k, v in w.items()}, _t(x, tdt),
                   activation=activation)
    want = jmlp.mlp({k: _j(v, jdt) for k, v in w.items()}, _j(x, jdt),
                    activation=activation)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_init_maker_draws_the_reference_distributions():
    g = torch.Generator().manual_seed(0)
    make = tcommon.init_maker(g, torch.float32, torch.device("cpu"))
    w = make("w", (512, 256))
    assert abs(float(w.std()) - 512 ** -0.5) < 0.02 * 512 ** -0.5
    assert abs(float(make("e", (300, 200), ("normal", 0.02)).std()) - 0.02) < 1e-3
    assert torch.equal(make("s", (7,), "ones"), torch.ones(7))
    assert torch.equal(make("b", (7,), "zeros"), torch.zeros(7))
    assert make("h", (4, 4)).dtype == torch.float32
    with pytest.raises(ValueError, match="not ported"):
        make("u", (3,), ("uniform", 1.0))


# ---------------------------------------------------------------------------
# K8's plain version
# ---------------------------------------------------------------------------

FLASH_CASES = [  # tests/test_kernels.py:120-125, with the reference's tiles
    (2, 64, 4, 2, 16, True, 16, 16),
    (1, 100, 2, 2, 32, True, 32, 16),    # ragged S vs blocks
    (2, 37, 4, 4, 8, False, 8, 8),       # bidirectional
    (1, 192, 2, 1, 64, True, 128, 64),   # MQA
]


def _qkv(b, s, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)), rng.standard_normal((b, s, kv, hd)),
            rng.standard_normal((b, s, kv, hd)))


@pytest.mark.parametrize("b,s,h,kv,hd,causal,qb,kb", FLASH_CASES)
def test_flash_attention_plain_matches_pallas_kernel(b, s, h, kv, hd, causal, qb, kb):
    q, k, v = _qkv(b, s, h, kv, hd)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    want = jops.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                                q_block=qb, kv_block=kb, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,qb,kb", FLASH_CASES)
def test_flash_attention_plain_matches_reference_oracle(b, s, h, kv, hd, causal,
                                                        qb, kb):
    q, k, v = _qkv(b, s, h, kv, hd, seed=1)
    got = fa.flash_attention_plain(_t(q), _t(k), _t(v), causal)
    rep = h // kv
    kk, vv = np.repeat(k, rep, 2), np.repeat(v, rep, 2)
    tb = lambda x: x.transpose(0, 2, 1, 3).reshape(b * h, s, hd)
    want = np.asarray(jref.flash_attention(_j(tb(q)), _j(tb(kk)), _j(tb(vv)), causal))
    want = want.reshape(b, h, s, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        tref.flash_attention(_t(tb(q)), _t(tb(kk)), _t(tb(vv)), causal).numpy(),
        np.asarray(jref.flash_attention(_j(tb(q)), _j(tb(kk)), _j(tb(vv)), causal)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dt", DTYPES)
def test_flash_attention_dtypes_match_pallas_kernel(dt):
    tdt, jdt, _ = DTYPES[dt]
    tol = dict(rtol=2e-5, atol=2e-5) if dt == "f32" else BF16
    q, k, v = _qkv(1, 48, 2, 2, 16, seed=2)
    got = ops.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt))
    assert got.dtype == tdt
    want = jops.flash_attention(_j(q, jdt), _j(k, jdt), _j(v, jdt), q_block=16,
                                kv_block=16, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_flash_attention_checks_its_inputs():
    q, k, v = (_t(a) for a in _qkv(1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16), v[:, :, :1].expand(1, 8, 3, 16))
    with pytest.raises(TypeError, match="float32 or"):
        ops.flash_attention(q.half(), k.half(), v.half())
    big = torch.zeros(1, 8, 1, 257)
    with pytest.raises(ValueError, match="head_dim 257"):
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_call(q, k, v, True)
    with pytest.raises(ValueError, match="route"):
        fa.flash_attention_call(q, k, v, True, route="wgmma")


@pytest.mark.parametrize("dtype,hd,aligned,want", [
    (torch.bfloat16, 64, True, "wgmma"), (torch.bfloat16, 128, True, "wgmma"),
    (torch.bfloat16, 64, False, "simt"), (torch.bfloat16, 128, False, "simt"),
    (torch.float32, 64, True, "simt"), (torch.float32, 128, True, "simt"),
    (torch.bfloat16, 7, True, "simt"), (torch.bfloat16, 8, True, "simt"),
    (torch.bfloat16, 16, True, "simt"), (torch.bfloat16, 32, True, "simt"),
    (torch.bfloat16, 96, True, "simt"), (torch.bfloat16, 192, True, "simt"),
    (torch.bfloat16, 256, True, "simt")])
def test_flash_attention_variant_rule(dtype, hd, aligned, want):
    """K8's route: the tensor-core kernel for bfloat16 at hd 64 and 128 when
    TMA can read the inputs, the SIMT kernel for everything else."""
    assert fa.variant(dtype, hd, aligned) == want


def test_flash_attention_tma_alignment_rule():
    """Base 16-byte aligned and every stride over (B, S, heads) of a
    dimension above size 1 a positive multiple of 16 bytes."""
    buf = torch.zeros((2, 9, 10 * 64), dtype=torch.bfloat16)
    q = buf[..., : 6 * 64].view(2, 9, 6, 64)        # projections in place
    k = buf[..., 6 * 64: 8 * 64].view(2, 9, 2, 64)
    assert fa.tma_aligned(q, k, k)
    assert fa.tma_aligned(q.contiguous(), q[:1], q[:, :1])
    assert not fa.tma_aligned(buf[..., 1:1 + 64 * 6].view(2, 9, 6, 64))   # base + 2 B
    wide = torch.zeros((2, 9, 3, 72), dtype=torch.bfloat16)[..., :64]
    assert fa.tma_aligned(wide)                       # 144-byte head stride
    assert not fa.tma_aligned(torch.zeros((2, 9, 3, 68), dtype=torch.bfloat16)[..., :64])
    assert not fa.tma_aligned(q[:1].expand(2, 9, 6, 64))   # stride 0 over B
    assert fa._map_strides(q[:1]) == [9 * 6 * 64, 640, 64]
    assert fa._map_strides(k[:, :, :1]) == [5760, 640, 64]


def _flash_bf16_p(q, k, v, causal, tile=128, out_dtype=None):
    """The wgmma route's arithmetic in plain torch: float32 scores of the
    inputs, the online softmax over 128-key tiles with p rounded to
    bfloat16 before p . v and l summed from the float32 p."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qf = q.float().reshape(b, s, kv, h // kv, hd)
    m = torch.full((b, kv, h // kv, s), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros((b, kv, h // kv, s, hd))
    pos = torch.arange(s)
    for k0 in range(0, s, tile):
        sc = torch.einsum("bqgrd,bkgd->bgrqk", qf, k[:, k0:k0 + tile].float()) * hd ** -0.5
        if causal:
            sc = sc.masked_fill(pos[k0:k0 + tile][None, :] > pos[:, None], -1e30)
        mn = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - mn)
        p = torch.exp(sc - mn[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(torch.bfloat16).float(), v[:, k0:k0 + tile].float())
        m = mn
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(out_dtype or q.dtype)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("hd", [128, 64])
def test_flash_attention_bf16_p_stays_within_tolerance(hd, causal):
    """The tolerance argument of the wgmma route: with p rounded to bfloat16
    for p . v, bf16 inputs (S = 300, H = 7, KV = 1) agree with the
    reference's Pallas kernel in interpret mode and with the float32 plain
    version within 2e-2; before the output's own rounding the move is at
    most 2^-8 max|v| (each p moves by at most 2^-8 of itself)."""
    q, k, v = (_t(a, torch.bfloat16) for a in _qkv(1, 300, 7, 1, hd, seed=hd))
    got = _flash_bf16_p(q, k, v, causal)
    want = jops.flash_attention(_j(q.float(), jnp.bfloat16), _j(k.float(), jnp.bfloat16),
                                _j(v.float(), jnp.bfloat16), causal=causal, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    exact = fa.flash_attention_plain(q, k, v, causal, torch.float32)
    np.testing.assert_allclose(_np(got), _np(exact), **BF16)
    moved = float((_flash_bf16_p(q, k, v, causal, out_dtype=torch.float32) - exact).abs().max())
    assert moved <= 2 ** -8 * float(v.float().abs().max()) + 1e-5, moved


# ---------------------------------------------------------------------------
# Attention sublayer
# ---------------------------------------------------------------------------

def _attn_weights(d, h, kv, hd, seed=3):
    rng = np.random.default_rng(seed)
    return {"wq": rng.standard_normal((d, h * hd)) * d ** -0.5,
            "wk": rng.standard_normal((d, kv * hd)) * d ** -0.5,
            "wv": rng.standard_normal((d, kv * hd)) * d ** -0.5,
            "wo": rng.standard_normal((h * hd, d)) * (h * hd) ** -0.5,
            "bq": 0.1 * rng.standard_normal(h * hd),
            "bk": 0.1 * rng.standard_normal(kv * hd),
            "bv": 0.1 * rng.standard_normal(kv * hd)}


@pytest.mark.parametrize("kv", [4, 2, 1])
def test_attention_with_kv_matches_reference(kv):
    d, h, hd, s = 64, 4, 16, PROMPT
    w = _attn_weights(d, h, kv, hd)
    x = np.random.default_rng(4).standard_normal((2, s, d))
    kw = dict(num_heads=h, num_kv_heads=kv, head_dim=hd, rope_theta=1e6,
              return_kv=True)
    out, (k, v) = tattn.attention({n: _t(a) for n, a in w.items()}, _t(x), **kw)
    jout, (jk, jv) = jattn.attention({n: _j(a) for n, a in w.items()}, _j(x),
                                     q_chunk=16, kv_chunk=16, **kw)
    for got, want in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_decode_attention_matches_reference():
    d, h, kv, hd, cap, pos = 64, 4, 2, 16, 12, 9
    w = _attn_weights(d, h, kv, hd)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, d))
    ck, cv = rng.standard_normal((2, 2, cap, kv, hd))
    kw = dict(num_heads=h, num_kv_heads=kv, head_dim=hd, rope_theta=1e4)
    cache = {"k": _t(ck), "v": _t(cv)}
    out, cache = tattn.decode_attention({n: _t(a) for n, a in w.items()}, _t(x),
                                        cache, pos, **kw)
    jout, jcache = jattn.decode_attention({n: _j(a) for n, a in w.items()}, _j(x),
                                          {"k": _j(ck), "v": _j(cv)},
                                          jnp.int32(pos), **kw)
    np.testing.assert_allclose(_np(out), _np(jout), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), **F32)


@pytest.mark.parametrize("kwargs,feature", [
    (dict(window=8), "window"),
    (dict(prefix_len=4), "prefix_len"),
    (dict(cross_kv=torch.zeros(1, 5, 64)), "cross_kv"),
])
def test_unported_attention_features_raise(kwargs, feature):
    """The prefix and cross-attention raise; the sliding window (ported)
    matches the reference's ``_sliding`` through ``attention``."""
    w = _attn_weights(64, 4, 2, 16)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16)
    if feature == "window":
        x = np.random.default_rng(6).standard_normal((2, PROMPT, 64))
        got = tattn.attention({n: _t(a) for n, a in w.items()}, _t(x), **kw,
                              **kwargs)
        want = jattn.attention({n: _j(a) for n, a in w.items()}, _j(x),
                               q_chunk=16, **kw, **kwargs)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        return
    with pytest.raises(NotImplementedError, match=feature):
        tattn.attention({n: _t(a) for n, a in w.items()}, torch.zeros(1, 5, 64),
                        **kw, **kwargs)


@pytest.mark.parametrize("kwargs,feature", [
    (dict(window=8), "window"), (dict(seq_shard_axis="data"), "seq_shard_axis"),
    (dict(cross=True), "cross")])
def test_unported_decode_features_raise(kwargs, feature):
    """The sequence-sharded and cross decodes raise; the windowed decode
    (ported) matches the reference's over a cache past the window."""
    w = _attn_weights(64, 4, 2, 16)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16)
    if feature == "window":
        cap, pos = 20, 15
        rng = np.random.default_rng(7)
        x = rng.standard_normal((2, 1, 64))
        ck, cv = rng.standard_normal((2, 2, cap, 2, 16))
        out, cache = tattn.decode_attention(
            {n: _t(a) for n, a in w.items()}, _t(x), {"k": _t(ck), "v": _t(cv)},
            pos, **kw, **kwargs)
        jout, jcache = jattn.decode_attention(
            {n: _j(a) for n, a in w.items()}, _j(x), {"k": _j(ck), "v": _j(cv)},
            jnp.int32(pos), **kw, **kwargs)
        np.testing.assert_allclose(_np(out), _np(jout), **F32)
        np.testing.assert_allclose(_np(cache["k"]), _np(jcache["k"]), **F32)
        return
    cache = tattn.init_kv_cache(1, 4, 2, 16, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match=feature):
        tattn.decode_attention({n: _t(a) for n, a in w.items()},
                               torch.zeros(1, 1, 64), cache, 0, **kw, **kwargs)


# ---------------------------------------------------------------------------
# Whole model: prefill + decode against the reference
# ---------------------------------------------------------------------------

WHOLE = {"qwen2-7b kv4": ("qwen2-7b", 4), "qwen2-7b kv2": ("qwen2-7b", 2),
         "qwen2-7b kv1": ("qwen2-7b", 1),
         "mistral-large-123b": ("mistral-large-123b", None),
         "command-r-plus-104b": ("command-r-plus-104b", None),
         "nemotron-4-340b": ("nemotron-4-340b", None)}


def _reduced(pkg, arch, kv):
    cfg = pkg.get_config(arch).reduced()
    return dataclasses.replace(cfg, num_kv_heads=kv) if kv else cfg


def _perturbed_tree(params, seed):
    """The reference's initial parameters as numpy, with the zero biases and
    unit norm scales perturbed so that their paths are exercised."""
    rng = np.random.default_rng(seed)

    def go(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = go(leaf)
                continue
            a = np.asarray(leaf, np.float32)
            if name in ("bq", "bk", "bv"):
                a = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
            elif name == "scale":
                a = (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
            out[name] = a
        return out
    return go(params)


@pytest.fixture(scope="module", params=list(WHOLE))
def whole_run(request):
    """One prefill of a ragged prompt and four decode steps (fixed tokens)
    through both packages from the same weights."""
    arch, kv = WHOLE[request.param]
    jcfg, tcfg = _reduced(jcfgs, arch, kv), _reduced(tcfgs, arch, kv)
    tree = _perturbed_tree(japi.build_model(jcfg).init(jax.random.PRNGKey(0)), 7)
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, jcfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    steps = rng.integers(0, jcfg.vocab_size, (DECODE_STEPS, BATCH, 1), dtype=np.int32)
    cap = PROMPT + DECODE_STEPS

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

    tmodel = tapi.build_model(tcfg, device="cpu")
    params = model_params_from_jax(tree, tcfg, device="cpu")
    cache = tmodel.init_cache(BATCH, cap, dtype=torch.float32)
    got = {}
    with torch.no_grad():
        lg, cache = tmodel.prefill(params, {"tokens": torch.from_numpy(prompt)},
                                   cache=cache)
        got["prefill"] = lg.numpy()
        for i, tok in enumerate(steps):
            lg, cache = tmodel.decode_step(params, cache, torch.from_numpy(tok),
                                           PROMPT + i)
            got[f"decode {i}"] = lg.numpy()
    return dict(got=got, want=want, cache=cache, jcache=jcache, cfg=tcfg,
                jcfg=jcfg, params=params, jparams=jparams, prompt=prompt)


def test_whole_model_logits_match_reference(whole_run):
    got, want = whole_run["got"], whole_run["want"]
    assert list(got) == ["prefill"] + [f"decode {i}" for i in range(DECODE_STEPS)]
    for name in got:
        assert got[name].dtype == np.float32 and got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **MODEL_TOL)


def test_whole_model_cache_matches_reference(whole_run):
    cache, jcache = whole_run["cache"], whole_run["jcache"]
    assert set(cache) == set(jcache)
    for pos, sub in jcache.items():
        assert set(cache[pos]) == set(sub)
        for name, want in sub.items():
            got = cache[pos][name]
            assert tuple(got.shape) == want.shape   # (periods, B, cap, KV, hd)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"{pos}.{name}", **MODEL_TOL)


def test_forward_hidden_matches_reference(whole_run):
    cfg, jcfg = whole_run["cfg"], whole_run["jcfg"]
    prompt = whole_run["prompt"]
    with torch.no_grad():
        h, aux = ttfm.forward_hidden(whole_run["params"], cfg, torch.from_numpy(prompt))
    jh, jaux = jtfm.forward_hidden(whole_run["jparams"], jcfg, jnp.asarray(prompt),
                                   remat=False, q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **MODEL_TOL)
    assert float(aux) == float(jaux) == 0.0


def test_default_prefill_cache_has_prompt_capacity():
    cfg = tcfgs.get_config("qwen2-7b").reduced()
    model = tapi.build_model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens})
        big = model.init_cache(2, 12, dtype=torch.float32)
        logits2, big = model.prefill(params, {"tokens": tokens}, cache=big)
    assert tuple(cache["pos0"]["k"].shape) == (2, 2, 9, 4, 64)
    assert torch.equal(logits, logits2)
    assert torch.equal(big["pos0"]["k"][:, :, :9], cache["pos0"]["k"])
    assert not bool(big["pos0"]["k"][:, :, 9:].any())
    with pytest.raises(ValueError, match="capacity"):
        model.prefill(params, {"tokens": tokens}, cache=model.init_cache(2, 8))


# ---------------------------------------------------------------------------
# What is not ported raises; conversion checks its tree; the CLI runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a for a in jcfgs.ARCH_NAMES
                                  if jcfgs.get_config(a).family != "dense"])
def test_unported_families_raise(arch):
    """The families still to port raise (jamba naming Mamba2, Queue A 11.4
    only); the MoE family builds and draws the reference's leaves."""
    cfg = tcfgs.get_config(arch).reduced()
    if cfg.family == "moe":
        params = tapi.build_model(cfg, device="cpu").init(0)
        jtree = japi.build_model(jcfgs.get_config(arch).reduced()).init(
            jax.random.PRNGKey(0))
        want = {f"blocks.{p}.{'.'.join(k.split('.')[2:])}": v[1:]
                for k, v in _flat_shapes(jtree).items() if k.startswith("blocks")
                for p in range(cfg.num_layers)}
        got = {n: tuple(t.shape) for n, t in params.named_parameters()
               if n.startswith("blocks")}
        assert got == want
        return
    with pytest.raises(NotImplementedError, match="not ported") as err:
        tapi.build_model(cfg, device="cpu")
    if cfg.family == "hybrid":
        assert "11.4" in str(err.value) and "11.3" not in str(err.value)


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def test_unported_blocks_and_window_raise():
    """A MoE block's cache and a windowed prefill run (the window a mask:
    one at or past S is plain causal attention, a smaller one moves the
    logits); the VLM prefix still raises."""
    cfg = tcfgs.get_config("qwen2-7b").reduced()
    moe = dataclasses.replace(cfg, pattern=(tcfgs.BlockSpec(kind="attn", moe=True),))
    cache = ttfm.init_decode_cache(moe, 1, 4, device="cpu")
    assert tuple(cache["pos0"]["k"].shape) == (2, 1, 4, 4, 64)
    params = tapi.build_model(cfg, device="cpu").init(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain, _ = ttfm.prefill(params, cfg, tokens)
        wide, _ = ttfm.prefill(params, dataclasses.replace(cfg, sliding_window=12),
                               tokens)
        narrow, _ = ttfm.prefill(params, cfg, tokens, window=8)
    assert torch.equal(plain, wide)
    assert not torch.allclose(plain, narrow)
    with pytest.raises(NotImplementedError, match="prefix"):
        ttfm.prefill(params, cfg, torch.zeros(1, 4, dtype=torch.long),
                     prefix_emb=torch.zeros(1, 2, cfg.d_model))


def test_model_params_from_jax_refuses_missing_and_extra_leaves():
    cfg = tcfgs.get_config("command-r-plus-104b").reduced()
    tree = jax.tree.map(np.asarray, japi.build_model(
        jcfgs.get_config("command-r-plus-104b").reduced()).init(jax.random.PRNGKey(1)))
    model = model_params_from_jax(tree, cfg, device="cpu")
    assert model.unembed is None and len(model.blocks) == 2
    np.testing.assert_array_equal(model.blocks[1].attn["wq"].numpy(),
                                  tree["blocks"]["pos0"]["attn"]["wq"][1])
    extra = dict(tree, unembed=np.zeros((cfg.d_model, cfg.vocab_size), np.float32))
    with pytest.raises(ValueError, match="extra"):
        model_params_from_jax(extra, cfg, device="cpu")
    missing = dict(tree, final_norm={})
    with pytest.raises(ValueError, match="missing"):
        model_params_from_jax(missing, cfg, device="cpu")


def test_serve_cli_runs_on_the_cpu(capsys):
    _build.LAUNCHES["flash_attention"] = 0
    res = serve.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                      "--prompt-len", "21", "--decode-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "prefill 21 tokens" in out and "tok/s" in out
    assert "sampled token ids (first seq)" in out
    assert tuple(res["tokens"].shape) == (2, 3)
    assert bool(torch.isfinite(res["logits"]).all())
    assert tuple(res["cache"]["pos0"]["k"].shape) == (2, 2, 24, 4, 64)
    assert _build.LAUNCHES["flash_attention"] == 0   # the CPU path launches nothing


def test_serve_mesh_raises():
    with pytest.raises(NotImplementedError, match="mesh"):
        serve.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                    "--mesh", "2x1"])
