"""The port's wires (``message_dtype`` ``bfloat16``, ``int8``, ``sign1``)
against the JAX reference, on the CPU.

* The registry, :meth:`PackSpec.encode` / ``decode`` / ``wire_roundtrip`` /
  ``transmit`` / ``wire_bytes`` and ``dequantize_slice`` against
  ``repro.core.packing``: int8 codes and scales bitwise (an all-zero block
  included), sign1 codes bitwise and scales at rtol 1e-6 (a sum in another
  order), at batch ranks 1 and 2 with padding.
* K1's plain version on bfloat16 against ``repro.core.saga.saga_correct_scatter``
  under ``jax.jit``, bitwise (both round after every bf16 operation); the
  reference's own ``ops.saga_correct`` does not run on this jax.
* K2-K7's plain versions on bfloat16: bitwise their own result on the
  float32 upcast, and the reference's ``ref.*`` and masked engine on the
  same bf16 input at rtol 1e-5.
* The master and decentralized steps (both gossip modes) under each wire,
  five steps from the reference's init state with its sample draws handed
  in: params and the error-feedback residuals against the reference at
  atol 2e-2 on the bf16 wire (bf16 keeps about 3 digits, and a last-bit
  difference upstream moves a bf16 rounding) and at rtol/atol 1e-5 on int8
  and sign1 (float32 buffers); partial participation and a guard-rejected
  round that keeps the residuals.
* The twin of ``tests/test_packing.py``'s bf16-tracks-f32 check.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RobustConfig as JConfig
from repro.core import make_federated_step as j_make_step
from repro.core import packing as jpacking
from repro.core import saga as jsaga
from repro.data import ijcnn1_like as j_ijcnn1_like
from repro.data import logreg_loss as j_logreg_loss
from repro.data import partition as j_partition
from repro.kernels import ref as jref
from repro.optim import get_optimizer as j_get_optimizer
from repro.topology import masked as jmasked
from repro_torch import convert
from repro_torch.core import RobustConfig, make_federated_step, packing
from repro_torch.core.aggregators import AGGREGATOR_NAMES
from repro_torch.core.geomed import segment_ids
from repro_torch.data import logreg_loss
from repro_torch.kernels import ops
from repro_torch.optim import get_optimizer

WIRES = ("bfloat16", "int8", "sign1")
STEPS = 5


def _np(x):
    """A torch tensor as numpy; bfloat16 as its uint16 bits."""
    if x.dtype == torch.bfloat16:
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _jnp(x):
    """A jax array as numpy; bfloat16 as its uint16 bits."""
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _bf16(a):
    """float32 numpy -> (the same values rounded to bf16 in torch, in jax)."""
    return torch.from_numpy(a).bfloat16(), jnp.asarray(a).astype(jnp.bfloat16)


def _tree(batch, rng):
    """Three leaves with ``batch`` leading axes; leaf "b" of the first
    message is all zero (an int8 block of scale 0)."""
    tree = {"a": rng.standard_normal(batch + (3, 4)).astype(np.float32),
            "b": 5.0 * rng.standard_normal(batch + (5,)).astype(np.float32),
            "c": 0.01 * rng.standard_normal(batch + (2, 3)).astype(np.float32)}
    tree["b"].reshape((-1, 5))[0] = 0.0
    return tree


def _specs(tree, nb, wire):
    jspec = jpacking.pack_spec({k: jnp.asarray(v) for k, v in tree.items()},
                               batch_ndim=nb, pad_to=8, wire=wire)
    tspec = packing.pack_spec({k: torch.from_numpy(v) for k, v in tree.items()},
                              batch_ndim=nb, pad_to=8, wire=wire)
    return jspec, tspec


# -- the registry and the codecs -------------------------------------------------

def test_registry_matches_reference():
    assert packing.WIRE_FORMAT_NAMES == jpacking.WIRE_FORMAT_NAMES
    for name, jfmt in jpacking.WIRE_FORMATS.items():
        fmt = packing.WIRE_FORMATS[name]
        assert (fmt.name, fmt.bits_per_coord, fmt.quantized,
                fmt.error_feedback) == (jfmt.name, jfmt.bits_per_coord,
                                        jfmt.quantized, jfmt.error_feedback)
        assert str(fmt.cast_dtype).removeprefix("torch.") == \
            jnp.dtype(jfmt.cast_dtype).name
        assert packing.resolve_message_dtype(name) == fmt.cast_dtype
    assert packing.resolve_wire_format(torch.bfloat16) is \
        packing.WIRE_FORMATS["bfloat16"]
    f16 = packing.resolve_wire_format(torch.float16)
    j16 = jpacking.resolve_wire_format(jnp.float16)
    assert (f16.name, f16.bits_per_coord, f16.quantized) == \
        (j16.name, j16.bits_per_coord, j16.quantized)
    with pytest.raises(ValueError, match="message_dtype must be one of"):
        packing.resolve_wire_format("fp4")


@pytest.mark.parametrize("wire", ["int8", "sign1"])
@pytest.mark.parametrize("batch", [(6,), (2, 3)])
def test_encode_decode_match_reference(wire, batch):
    rng = np.random.default_rng(len(batch) + (wire == "sign1"))
    tree = _tree(batch, rng)
    tree["a"].reshape(-1)[3] = -tree["a"].reshape(-1)[3]   # a sign either way
    jspec, tspec = _specs(tree, len(batch), wire)
    assert tspec.quantized and tspec.padded_dim == jspec.padded_dim == 24
    jbuf = jspec.pack({k: jnp.asarray(v) for k, v in tree.items()},
                      batch_ndim=len(batch))
    tbuf = tspec.pack({k: torch.from_numpy(v) for k, v in tree.items()},
                      batch_ndim=len(batch))
    jc, js = jspec.encode(jbuf)
    tc, ts = tspec.encode(tbuf)
    assert tc.dtype == torch.int8 and tuple(ts.shape) == batch + (3,)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert not tc[..., tspec.dim:].any()                     # padding -> 0
    if wire == "int8":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert float(ts.reshape(-1, 3)[0, 1]) == 0.0          # all-zero block
    else:
        assert set(np.unique(tc[..., :tspec.dim].numpy())) == {-1, 1}
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    dec = tspec.decode(tc, ts)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jspec.decode(jc, js)),
                               rtol=1e-6, atol=0)
    rt = tspec.wire_roundtrip(tbuf)
    np.testing.assert_array_equal(rt.numpy(), dec.numpy())
    # Idempotent: the codes come back, the values to the last digit or so.
    rc, _ = tspec.encode(rt)
    np.testing.assert_array_equal(rc.numpy(), tc.numpy())
    np.testing.assert_allclose(tspec.wire_roundtrip(rt).numpy(), rt.numpy(),
                               rtol=1e-6, atol=0)


def test_sign1_codes_nan_and_zero():
    """sign1 sends +1 for v >= 0 (zero included) and -1 otherwise, NaN
    included, as the reference does."""
    v = np.array([[0.0, -0.0, 2.0, -3.0, np.nan, 1.0]], np.float32)
    jspec = jpacking.pack_spec({"w": jnp.asarray(v)}, wire="sign1")
    tspec = packing.pack_spec({"w": torch.from_numpy(v)}, wire="sign1")
    np.testing.assert_array_equal(tspec.encode(torch.from_numpy(v))[0].numpy(),
                                  np.asarray(jspec.encode(jnp.asarray(v))[0]))


@pytest.mark.parametrize("wire", WIRES + ("float32",))
def test_roundtrip_and_transmit(wire):
    """Formats that are not quantized return the very object; sign1's
    transmit keeps ``wire + residual`` equal to what it had to send and
    needs a residual; int8 passes the residual through."""
    rng = np.random.default_rng(3)
    tree = _tree((4,), rng)
    _, tspec = _specs(tree, 1, wire)
    buf = tspec.pack({k: torch.from_numpy(v) for k, v in tree.items()})
    res = torch.from_numpy(
        0.1 * rng.standard_normal(buf.shape).astype(np.float32))
    if wire in ("float32", "bfloat16"):
        assert buf.dtype == packing.WIRE_FORMATS[wire].cast_dtype
        assert tspec.wire_roundtrip(buf) is buf
        out, r = tspec.transmit(buf, res)
        assert out is buf and r is res
        with pytest.raises(ValueError, match="not quantized"):
            tspec.encode(buf)
        return
    if wire == "int8":
        out, r = tspec.transmit(buf, res)
        assert r is res
        np.testing.assert_array_equal(out.numpy(),
                                      tspec.wire_roundtrip(buf).numpy())
        return
    with pytest.raises(ValueError, match="error feedback"):
        tspec.transmit(buf)
    out, r = tspec.transmit(buf, res)
    np.testing.assert_allclose((out + r).numpy(), (buf + res).numpy(),
                               rtol=1e-6, atol=1e-7)
    jspec, _ = _specs(tree, 1, wire)
    jout, jr = jspec.transmit(jnp.asarray(buf.numpy()), jnp.asarray(res.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wire", ["int8", "sign1"])
def test_dequantize_slice_equals_decode(wire):
    rng = np.random.default_rng(4)
    tree = _tree((5,), rng)
    jspec, tspec = _specs(tree, 1, wire)
    buf = tspec.pack({k: torch.from_numpy(v) for k, v in tree.items()})
    codes, scales = tspec.encode(buf)
    full = tspec.decode(codes, scales)
    seg = segment_ids(tspec.boundaries, tspec.padded_dim, torch.device("cpu"))
    for lo, hi in ((0, 24), (7, 19), (16, 24)):
        got = packing.dequantize_slice(codes[:, lo:hi], scales, seg[lo:hi])
        np.testing.assert_array_equal(got.numpy(), full[:, lo:hi].numpy())
        want = jpacking.dequantize_slice(jnp.asarray(codes.numpy()[:, lo:hi]),
                                         jnp.asarray(scales.numpy()),
                                         jnp.asarray(seg.numpy()[lo:hi]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wire", WIRES + ("float32",))
def test_wire_bytes_match_reference(wire):
    tree = _tree((2,), np.random.default_rng(5))
    jspec, tspec = _specs(tree, 1, wire)
    assert tspec.wire_bytes() == jspec.wire_bytes()
    assert tspec.wire_format.quantized == jspec.quantized


# -- K1 on bfloat16 ------------------------------------------------------------------

def _saga_bf16(w, j, d, c=None, seed=0):
    rng = np.random.default_rng(seed)
    c = w if c is None else c
    grad = rng.standard_normal((w, d)).astype(np.float32)
    table = rng.standard_normal((c, j, d)).astype(np.float32)
    avg = table.mean(1) + 0.01 * rng.standard_normal((c, d)).astype(np.float32)
    idx = rng.integers(0, j, size=w)
    return grad, table, avg, idx


@pytest.mark.parametrize("w,j,d", [(5, 7, 300), (3, 1200, 64), (8, 3, 129)])
def test_k1_plain_bf16_equals_reference_scatter_bitwise(w, j, d):
    """msg, avg and table: the reference's saga_correct_scatter on bf16
    under jit, bit for bit (delta, msg and avg each rounded to bf16)."""
    grad, table, avg, idx = _saga_bf16(w, j, d, seed=w + j)
    tg, jg = _bf16(grad)
    tt, jt = _bf16(table)
    ta, ja = _bf16(avg)
    want_msg, want = jax.jit(jsaga.saga_correct_scatter)(
        jsaga.SagaState(jt, ja), jg, jnp.asarray(idx, jnp.int32))
    msg = ops.saga_correct(tg, tt, ta, torch.from_numpy(idx))
    assert msg.dtype == tt.dtype == ta.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(msg), _jnp(want_msg))
    np.testing.assert_array_equal(_np(ta), _jnp(want.avg))
    np.testing.assert_array_equal(_np(tt), _jnp(want.table))


def test_k1_plain_bf16_client_rows_bitwise():
    """The client-row route on a bf16 table resident per client: the
    reference's scatter on the gathered rows, written back, bit for bit."""
    grad, table, avg, idx = _saga_bf16(4, 5, 200, c=11, seed=7)
    rows = np.array([9, 2, 5, 0])
    tg, jg = _bf16(grad)
    tt, jt = _bf16(table)
    ta, ja = _bf16(avg)
    want_msg, want = jax.jit(jsaga.saga_correct_scatter)(
        jsaga.SagaState(jt[rows], ja[rows]), jg, jnp.asarray(idx, jnp.int32))
    msg = ops.saga_correct(tg, tt, ta, torch.from_numpy(idx),
                           torch.from_numpy(rows))
    np.testing.assert_array_equal(_np(msg), _jnp(want_msg))
    np.testing.assert_array_equal(_np(ta)[rows], _jnp(want.avg))
    np.testing.assert_array_equal(_np(tt)[rows], _jnp(want.table))
    others = np.setdiff1d(np.arange(11), rows)
    np.testing.assert_array_equal(_np(tt)[others], _jnp(jt)[others])


def test_saga_init_mean_of_a_bf16_table_matches_jnp_mean():
    """The bf16 table's running mean: accumulated in float32 and rounded
    once, as ``jnp.mean`` of a bf16 table (the reference's saga_init), bit
    for bit."""
    from repro_torch.core import saga
    rng = np.random.default_rng(11)
    table = rng.standard_normal((3, 50, 700)).astype(np.float32)
    tt, jt = _bf16(table)
    st = saga.saga_init(tt)
    assert st.table is tt and st.avg.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(st.avg),
                                  _jnp(jax.jit(jsaga.saga_init)(jt).avg))
    zeros = saga.saga_init_zeros({"w": torch.zeros(3, 2)}, 4, 5,
                                 dtype=torch.bfloat16)
    assert zeros.table.dtype == zeros.avg.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["sign_flip", "zero_gradient", "alie", "ipm",
                                  "straggler", "dropout", "nan",
                                  "inf_overflow", "bitflip"])
def test_attacks_on_a_bf16_buffer_match_reference(name):
    """Every deterministic attack on a bf16 (W_h, D) buffer: the reference's
    bf16 rows bit for bit (bitflip flips the float32 encoding's bit and
    casts back; alie's root is taken of the bf16 variance, as jnp.std)."""
    from repro.core import attacks as jattacks
    from repro_torch.core import attacks
    rng = np.random.default_rng(12)
    tree = {"a": rng.standard_normal((6, 40)).astype(np.float32),
            "b": rng.standard_normal((6, 9)).astype(np.float32)}
    jspec, tspec = _specs(tree, 1, "bfloat16")
    jbuf = jspec.pack({k: jnp.asarray(v) for k, v in tree.items()})
    tbuf = tspec.pack({k: torch.from_numpy(v) for k, v in tree.items()})
    np.testing.assert_array_equal(_np(tbuf), _jnp(jbuf))
    kw = dict(name=name, num_byzantine=3, bitflip_prob=0.3)
    want = jattacks.apply_attack(jattacks.AttackConfig(**kw), jbuf,
                                 jax.random.PRNGKey(0), spec=jspec)
    got = attacks.apply_attack(attacks.AttackConfig(**kw), tbuf, spec=tspec)
    assert got.dtype == torch.bfloat16 and got.shape == (9, 56)
    np.testing.assert_array_equal(_np(got), _jnp(want))


# -- K2-K7 on bfloat16 ---------------------------------------------------------------

def _msgs_bf16(w, d, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((w, d)).astype(np.float32)
    z[1] = z[0]                                          # ties
    y = rng.standard_normal(d).astype(np.float32)
    a = (rng.random(w) + 0.2).astype(np.float32)
    a[2] = 0.0
    return z, y, a


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("w,d", [(7, 300), (8, 64), (130, 40)])
def test_flat_plain_kernels_on_bf16(w, d):
    """K2, K3, K4, K5, K6 on a bf16 z: bitwise themselves on z.float(),
    float32 out, and the reference's ref.* at rtol 1e-5."""
    z, y, a = _msgs_bf16(w, d, seed=w)
    tz, jz = _bf16(z)
    ty, ta = torch.from_numpy(y), torch.from_numpy(a)
    zf = tz.float()
    seg = torch.from_numpy((np.arange(d) * 3 // d).astype(np.int32))
    seg[-5:] = 3                                         # padding: no segment
    got = {
        "sqdist": (ops.partial_sqdist(tz, ty), ops.partial_sqdist(zf, ty),
                   jref.partial_sqdist(jz, jnp.asarray(y))),
        "wsum": (ops.weighted_sum(tz, ta), ops.weighted_sum(zf, ta),
                 jref.weighted_sum(jz, jnp.asarray(a)) * float(a.sum())),
        "median": (ops.coordinate_median(tz), ops.coordinate_median(zf),
                   jnp.median(jz.astype(jnp.float32), axis=0)),
        "trimmed": (ops.trimmed_mean(tz, trim=2), ops.trimmed_mean(zf, trim=2),
                    jref.trimmed_mean(jz.astype(jnp.float32), 2)),
        "segments": (ops.partial_sqdist_segments(tz, ty, seg, num_segments=3),
                     ops.partial_sqdist_segments(zf, ty, seg, num_segments=3),
                     jref.partial_sqdist_segments(
                         jz, jnp.asarray(y), jnp.asarray(seg.numpy()), 3)),
    }
    for name, (bf, f32, ref) in got.items():
        assert bf.dtype == torch.float32, name
        _same(bf, f32)
        np.testing.assert_allclose(bf.numpy(), np.asarray(ref, np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("trim", [0, 1, 2])
def test_masked_plain_kernels_on_bf16(trim):
    """K7, the masked and receiver-batched K2 and the batched K3 on a bf16
    (R, S, D) exchange: bitwise themselves on the float32 upcast, and the
    reference's ref.masked_neighbor_reduce and masked engine at rtol 1e-5."""
    rng = np.random.default_rng(trim)
    r, s, d = 7, 7, 300
    ex = rng.standard_normal((r, s, d)).astype(np.float32)
    ex[:, 3] = ex[:, 2]                                   # ties
    mask = (rng.random((r, s)) < 0.8).astype(np.float32)
    np.fill_diagonal(mask, 1.0)
    mask[:, :5] = 1.0
    y = rng.standard_normal((r, d)).astype(np.float32)
    tex, jex = _bf16(ex)
    tm, ty = torch.from_numpy(mask), torch.from_numpy(y)
    ef = tex.float()
    _same(ops.masked_neighbor_reduce(tex, tm, trim=trim),
          ops.masked_neighbor_reduce(ef, tm, trim=trim))
    np.testing.assert_allclose(
        ops.masked_neighbor_reduce(tex, tm, trim=trim).numpy(),
        np.asarray(jref.masked_neighbor_reduce(jex, jnp.asarray(mask), trim)),
        rtol=1e-5, atol=1e-5)
    _same(ops.partial_sqdist(tex, ty, tm), ops.partial_sqdist(ef, ty, tm))
    _same(ops.partial_sqdist(tex, ty), ops.partial_sqdist(ef, ty))
    _same(ops.weighted_sum(tex, tm), ops.weighted_sum(ef, tm))
    from repro_torch.topology import masked as tmasked
    name = "trimmed_mean" if trim else "geomed"
    want = jmasked.masked_aggregate_flat(name, jex, jnp.asarray(mask), trim=trim)
    got = tmasked.masked_aggregate_flat(name, tex, tm, trim=trim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-5)


def test_float16_raises_everywhere():
    z = torch.zeros((3, 8), dtype=torch.float16)
    for call in (lambda: ops.coordinate_median(z),
                 lambda: ops.trimmed_mean(z, trim=1),
                 lambda: ops.masked_neighbor_reduce(z[None], torch.ones(1, 3)),
                 lambda: ops.partial_sqdist_segments(
                     z, torch.zeros(8), torch.zeros(8, dtype=torch.int32),
                     num_segments=1)):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            call()


# -- the steps -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _logreg(num_rows):
    data = j_ijcnn1_like(jax.random.PRNGKey(0), n=960)
    wd = j_partition({"a": data.x, "b": data.y}, num_rows, seed=1)
    return j_logreg_loss(0.01), logreg_loss(0.01), wd


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _tol(wire):
    return (dict(rtol=0, atol=2e-2) if wire == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


def _split_losses(rho=0.01):
    """The logistic loss of ``_logreg`` on three leaves: the weights of the
    first 12 features as u (3, 4), of the other 10 as v (10,), and a bias
    c (1,), each under the l2 term (jax, torch)."""
    def j_loss(params, batch):
        u, v, c = params["u"], params["v"], params["c"]
        z = batch["a"][:, :12] @ u.reshape(12) + batch["a"][:, 12:] @ v + c[0]
        m = -batch["b"] * z
        reg = jnp.sum(u * u) + jnp.sum(v * v) + jnp.sum(c * c)
        return jnp.mean(jnp.logaddexp(0.0, m)) + 0.5 * rho * reg

    def t_loss(params, batch):
        u, v, c = params["u"], params["v"], params["c"]
        z = batch["a"][:, :12] @ u.reshape(12) + batch["a"][:, 12:] @ v + c[0]
        m = -batch["b"] * z
        reg = torch.sum(u * u) + torch.sum(v * v) + torch.sum(c * c)
        return torch.mean(torch.logaddexp(torch.zeros_like(m), m)) + 0.5 * rho * reg

    return j_loss, t_loss


def _run_pair(cfg, num_rows, wh, *, steps=STEPS, lr=0.05, reject_at=None,
              params=None, losses=None):
    """``steps`` steps of the reference (jitted) and the port (CPU) from
    the reference's init state, the port handed the reference's sample
    draws and lsvrg coins.  ``reject_at``: before that step both states get
    a health vector whose EMA makes the guards reject the round; the port's
    residuals before it are returned too.  ``params`` (numpy leaves) and
    ``losses`` (jax, torch) replace the logistic model's {"w": zeros(22)}."""
    j_loss, t_loss, wd = _logreg(num_rows)
    if losses is not None:
        j_loss, t_loss = losses
    j_init, j_step = j_make_step(j_loss, wd, JConfig(**cfg),
                                 j_get_optimizer("sgd", lr))
    _, t_step = make_federated_step(t_loss, _numpy(wd), RobustConfig(**cfg),
                                    get_optimizer("sgd", lr), device="cpu")
    if params is None:
        params = {"w": np.zeros(22, np.float32)}
    j_state = j_init({k: jnp.asarray(v) for k, v in params.items()},
                     jax.random.PRNGKey(5))
    t_state = convert.state_from_jax(_numpy(j_state), device="cpu")
    j = next(iter(wd.values())).shape[1]
    j_step = jax.jit(j_step)
    held = None
    for step in range(steps):
        if step == reject_at:
            poison = np.array([1e-8, 1e-16, 0.0, 10.0], np.float32)
            j_state = j_state._replace(health=jnp.asarray(poison))
            t_state = t_state._replace(health=torch.from_numpy(poison))
            held = (t_state.ef.clone(), t_state.params["w"].clone())
        _, k_idx, _ = jax.random.split(j_state.key, 3)
        idx = np.array(jax.random.randint(k_idx, (wh,), 0, j))
        coin = None
        if cfg.get("vr") == "lsvrg":
            coin = np.array(jax.random.bernoulli(
                jax.random.fold_in(k_idx, 1), cfg["lsvrg_p"], (wh,)))
        j_state, j_metrics = j_step(j_state)
        t_state, t_metrics = t_step(t_state, sample_idx=idx, coin=coin)
    return j_state, j_metrics, t_state, t_metrics, held


def _assert_states(t_state, j_state, wire):
    tol = _tol(wire)
    assert set(t_state.params) == set(j_state.params)
    for k, leaf in t_state.params.items():
        np.testing.assert_allclose(leaf.float().numpy(),
                                   np.asarray(j_state.params[k], np.float32),
                                   err_msg=k, **tol)
    for leaf_t, leaf_j in zip(t_state.vr, j_state.vr):
        assert str(leaf_t.dtype).removeprefix("torch.") == \
            np.asarray(leaf_j).dtype.name
        np.testing.assert_allclose(leaf_t.float().numpy(),
                                   np.asarray(leaf_j, np.float32), **tol)
    if wire == "sign1":
        np.testing.assert_allclose(t_state.ef.numpy(), np.asarray(j_state.ef),
                                   **tol)
    else:
        assert t_state.ef is None and j_state.ef is None


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("agg", ["geomed", "trimmed_mean"])
def test_master_step_parity_under_each_wire(wire, agg):
    """12 workers + 2 sign_flip rows, SAGA: params, table, avg and the
    residuals against the reference after five steps."""
    cfg = dict(aggregator=agg, vr="saga", attack="sign_flip", num_byzantine=2,
               trim=2, weiszfeld_iters=32, message_dtype=wire)
    j_state, j_m, t_state, t_m, _ = _run_pair(cfg, 12, 12)
    _assert_states(t_state, j_state, wire)
    np.testing.assert_allclose(float(t_m["honest_variance"]),
                               float(j_m["honest_variance"]),
                               rtol=2e-2 if wire == "bfloat16" else 1e-4)


@pytest.mark.parametrize("wire", ["int8", "sign1"])
@pytest.mark.parametrize("agg", AGGREGATOR_NAMES)
def test_master_step_parity_three_leaves_every_rule(wire, agg):
    """Every rule of the registry under the quantized wires on a model of
    three leaves (int8/sign1 scales per leaf block, geomed_blockwise's
    leaves): params, table, avg and the residuals against the reference
    after five steps, 12 workers + 2 sign_flip rows."""
    rng = np.random.default_rng(11)
    params = {"u": 0.1 * rng.standard_normal((3, 4)).astype(np.float32),
              "v": 0.1 * rng.standard_normal(10).astype(np.float32),
              "c": np.zeros(1, np.float32)}
    cfg = dict(aggregator=agg, vr="saga", attack="sign_flip", num_byzantine=2,
               trim=2, weiszfeld_iters=32, num_groups=3, clip_radius=1.0,
               message_dtype=wire)
    j_state, _, t_state, _, _ = _run_pair(cfg, 12, 12, params=params,
                                          losses=_split_losses())
    _assert_states(t_state, j_state, wire)


@pytest.mark.parametrize("wire,case", [("sign1", "participation"),
                                       ("bfloat16", "participation"),
                                       ("bfloat16", "lsvrg"),
                                       ("sign1", "lsvrg-participation")])
def test_master_step_parity_options(wire, case):
    """Partial participation (C = 12, cohorts of 4, straggler slots with
    staleness weights): the cohort's residual and table rows move in
    place; lsvrg's bf16 snapshot and anchor with the reference's coins."""
    cfg = dict(aggregator="geomed", vr="saga", attack="sign_flip",
               num_byzantine=2, weiszfeld_iters=32, message_dtype=wire)
    rows, wh = 12, 12
    if "lsvrg" in case:
        cfg.update(vr="lsvrg", lsvrg_p=0.5)
    if "participation" in case:
        cfg.update(num_clients=12, cohort_size=4, attack="straggler",
                   staleness_decay=0.9)
        wh = 4
    j_state, _, t_state, _, _ = _run_pair(cfg, rows, wh)
    if wire == "sign1":
        assert t_state.ef.shape == (12, 22)
    _assert_states(t_state, j_state, wire)


@pytest.mark.parametrize("participate", [False, True])
def test_guard_rejected_round_keeps_residuals(participate):
    """sign1 with guards: a round the verdict rejects keeps params and the
    residual rows (written back in place under partial participation), as
    the reference's select does."""
    cfg = dict(aggregator="geomed", vr="saga", attack="sign_flip",
               num_byzantine=2, weiszfeld_iters=32, message_dtype="sign1",
               guards=True, reject_warmup=1)
    wh = 12
    if participate:
        cfg.update(num_clients=12, cohort_size=4)
        wh = 4
    j_state, j_m, t_state, t_m, held = _run_pair(cfg, 12, wh, steps=3,
                                                 reject_at=2)
    assert float(t_m["round_accepted"]) == float(j_m["round_accepted"]) == 0.0
    np.testing.assert_array_equal(t_state.ef.numpy(), held[0].numpy())
    np.testing.assert_array_equal(t_state.params["w"].numpy(), held[1].numpy())
    _assert_states(t_state, j_state, "sign1")


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("gossip", ["gradient", "params"])
def test_decentralized_step_parity_under_each_wire(wire, gossip):
    """A ring of 8 honest + 2 sign_flip nodes: per-node params, the table
    and the residuals (the gradient channel's, or the param channel's in
    params gossip) against the reference after five steps; the exchange is
    bf16 on the bf16 wire."""
    cfg = dict(aggregator="geomed", vr="saga", attack="sign_flip",
               num_byzantine=2, topology="ring", gossip=gossip,
               weiszfeld_iters=32, message_dtype=wire)
    j_state, j_m, t_state, t_m, _ = _run_pair(cfg, 8, 8)
    assert t_state.params["w"].shape == (10, 22)
    _assert_states(t_state, j_state, wire)
    np.testing.assert_allclose(float(t_m["consensus_dist"]),
                               float(j_m["consensus_dist"]),
                               rtol=5e-2 if wire == "bfloat16" else 1e-4,
                               atol=1e-9)


def test_decentralized_participation_sign1_parity():
    """Partial participation on the decentralized step: the cohort's
    residual rows move with it."""
    cfg = dict(aggregator="trimmed_mean", trim=1, vr="saga",
               attack="straggler", num_byzantine=2, topology="complete",
               num_clients=12, cohort_size=6, staleness_decay=0.9,
               message_dtype="sign1")
    j_state, _, t_state, _, _ = _run_pair(cfg, 12, 6)
    _assert_states(t_state, j_state, "sign1")


def test_bf16_message_mode_runs_and_tracks_f32():
    """Twin of tests/test_packing.py's check: 10 bf16 steps stay within
    atol 5e-2 of the float32 wire's, and the SAGA table is bf16."""
    data = j_ijcnn1_like(jax.random.PRNGKey(0), n=400)
    wd = _numpy(j_partition({"a": data.x, "b": data.y}, 8, seed=1))
    outs = {}
    for mdt in ("float32", "bfloat16"):
        cfg = RobustConfig(aggregator="geomed", vr="saga", attack="sign_flip",
                           num_byzantine=2, weiszfeld_iters=16,
                           message_dtype=mdt)
        init_fn, step_fn = make_federated_step(
            logreg_loss(0.01), wd, cfg, get_optimizer("sgd", 0.02),
            device="cpu")
        st = init_fn({"w": torch.zeros(22)}, 3)
        for _ in range(10):
            st, m = step_fn(st)
        assert np.isfinite(float(m["honest_variance"]))
        outs[mdt] = st
    w16 = outs["bfloat16"].params["w"].numpy()
    assert np.isfinite(w16).all()
    np.testing.assert_allclose(w16, outs["float32"].params["w"].numpy(),
                               atol=5e-2)
    assert outs["bfloat16"].vr.table.dtype == torch.bfloat16
    assert outs["bfloat16"].vr.avg.dtype == torch.bfloat16
