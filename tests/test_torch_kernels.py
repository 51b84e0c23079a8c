"""Kernels K1-K3 of the PyTorch port against the JAX reference.

On the CPU the port's dispatch runs each kernel's plain PyTorch version;
those are held against ``repro.kernels.ref``, the reference's Pallas
kernels in interpret mode (K2, K3) and ``core/saga.saga_correct_scatter``
(K1; the reference's ``ops.saga_correct`` does not run on jax 0.9.0).
Tolerance 1e-6 (rtol and atol, float32): only the summation order differs.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import saga as jsaga
from repro.kernels import ref as jref
from repro.kernels import weiszfeld as jwz
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import saga_correct as sc
from repro_torch.kernels import weiszfeld as wz

SHAPES = [(7, 300), (3, 1), (16, 512)]
J = 4
TOL = dict(rtol=1e-6, atol=1e-6)


def _msgs(w, p, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((w, p)).astype(np.float32)
    y = z.mean(axis=0) + 0.1 * rng.standard_normal(p).astype(np.float32)
    a = rng.uniform(0.5, 2.0, w).astype(np.float32)
    return z, y, a


def _saga_inputs(w, p, seed=0):
    rng = np.random.default_rng(seed)
    grad = rng.standard_normal((w, p)).astype(np.float32)
    table = rng.standard_normal((w, J, p)).astype(np.float32)
    avg = table.mean(axis=1)
    idx = (np.arange(w) * 3 + 1) % J          # covers rows 0 and J - 1
    return grad, table, avg, idx


def _pad(x, tile=jwz.DEFAULT_TILE):
    pad = (-x.shape[-1]) % tile
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("w,p", SHAPES)
def test_partial_sqdist_plain_vs_reference(w, p):
    z, y, _ = _msgs(w, p)
    got = ops.partial_sqdist(_t(z), _t(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.partial_sqdist(z, y)), **TOL)
    pallas = jwz.partial_sqdist_call(jnp.asarray(_pad(z)), jnp.asarray(_pad(y)),
                                     interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ref.partial_sqdist(_t(z), _t(y)).numpy(), got, **TOL)


@pytest.mark.parametrize("w,p", SHAPES)
def test_weighted_sum_plain_vs_reference(w, p):
    z, _, a = _msgs(w, p)
    got = ops.weighted_sum(_t(z), _t(a)).numpy()
    pallas = jwz.weighted_sum_call(jnp.asarray(_pad(z)), jnp.asarray(a),
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas)[:p], **TOL)
    np.testing.assert_allclose(got / a.sum(), np.asarray(jref.weighted_sum(z, a)),
                               **TOL)
    np.testing.assert_allclose(ref.weighted_sum(_t(z), _t(a)).numpy(),
                               np.asarray(jref.weighted_sum(z, a)), **TOL)


@pytest.mark.parametrize("w,p", SHAPES)
def test_weighted_sum_plain_with_zero_weight_rows_vs_reference(w, p):
    """K3's plain version where some weights are 0 (the rows the card's
    kernel skips): equal to the reference and to the sum over the nonzero
    rows alone; a receiver whose weights are all 0 gives exactly 0."""
    z, _, a = _msgs(w, p, seed=w + p)
    a[::2] = 0.0
    if not a.any():
        a[-1] = 1.5
    got = ops.weighted_sum(_t(z), _t(a)).numpy()
    np.testing.assert_allclose(got / a.sum(), np.asarray(jref.weighted_sum(z, a)), **TOL)
    keep = a != 0
    np.testing.assert_allclose(got, ops.weighted_sum(_t(z[keep]), _t(a[keep])).numpy(),
                               **TOL)
    batched = ops.weighted_sum(_t(np.stack([z, z])), _t(np.stack([a, 0 * a]))).numpy()
    np.testing.assert_allclose(batched[0], got, **TOL)
    assert not batched[1].any()


@pytest.mark.parametrize("w,p", SHAPES)
def test_weiszfeld_ref_vs_reference(w, p):
    z, y, _ = _msgs(w, p)
    np.testing.assert_allclose(ref.weiszfeld_step(_t(z), _t(y)).numpy(),
                               np.asarray(jref.weiszfeld_step(z, y)), **TOL)
    np.testing.assert_allclose(ref.geomed(_t(z), iters=8).numpy(),
                               np.asarray(jref.geomed(jnp.asarray(z), iters=8)),
                               **TOL)


@pytest.mark.parametrize("w,p", SHAPES)
def test_saga_correct_plain_vs_reference(w, p):
    grad, table, avg, idx = _saga_inputs(w, p)
    tab_t, avg_t = _t(table), _t(avg)
    msg = ops.saga_correct(_t(grad), tab_t, avg_t, _t(idx))
    # Against the single-worker oracle, vmapped over the workers.
    m, na, nt = jax.vmap(jref.saga_correct)(
        *map(jnp.asarray, (grad, table, avg, idx.astype(np.int32))))
    np.testing.assert_allclose(msg.numpy(), np.asarray(m), **TOL)
    np.testing.assert_allclose(avg_t.numpy(), np.asarray(na), **TOL)
    np.testing.assert_array_equal(tab_t.numpy(), np.asarray(nt))
    # Against the production scatter on the packed (W, J, p) state.
    msgs, st = jsaga.saga_correct_scatter(
        jsaga.SagaState(table=jnp.asarray(table), avg=jnp.asarray(avg)),
        jnp.asarray(grad), jnp.asarray(idx, jnp.int32))
    np.testing.assert_allclose(msg.numpy(), np.asarray(msgs), **TOL)
    np.testing.assert_allclose(avg_t.numpy(), np.asarray(st.avg), **TOL)
    np.testing.assert_array_equal(tab_t.numpy(), np.asarray(st.table))


@pytest.mark.parametrize("w,p", SHAPES)
def test_saga_correct_in_place_contract(w, p):
    """The aliased-row contract: the message is built from the OLD row,
    the drawn row becomes the gradient bit-exactly, every other row stays,
    and the port's functional oracle agrees with the in-place update."""
    grad, table, avg, idx = _saga_inputs(w, p, seed=1)
    tab_t, avg_t = _t(table), _t(avg)
    want_msg, want_avg, want_tab = ref.saga_correct(_t(grad), _t(table),
                                                    _t(avg), _t(idx))
    msg = ops.saga_correct(_t(grad), tab_t, avg_t, _t(idx))
    rows = np.arange(w)
    np.testing.assert_array_equal(tab_t.numpy()[rows, idx], grad)
    keep = np.ones((w, J), bool)
    keep[rows, idx] = False
    np.testing.assert_array_equal(tab_t.numpy()[keep], table[keep])
    np.testing.assert_allclose(msg.numpy(), grad - table[rows, idx] + avg, **TOL)
    np.testing.assert_array_equal(msg.numpy(), want_msg.numpy())
    np.testing.assert_array_equal(avg_t.numpy(), want_avg.numpy())
    np.testing.assert_array_equal(tab_t.numpy(), want_tab.numpy())


def test_cpu_dispatch_counts_no_launch():
    ops.reset_launch_counts()
    z, y, a = _msgs(7, 300)
    grad, table, avg, idx = _saga_inputs(7, 300)
    ops.partial_sqdist(_t(z), _t(y))
    ops.weighted_sum(_t(z), _t(a))
    ops.saga_correct(_t(grad), _t(table), _t(avg), _t(idx))
    ops.coordinate_median(_t(z))
    ops.trimmed_mean(_t(z), trim=2)
    ops.partial_sqdist_segments(_t(z), _t(y), torch.zeros(300, dtype=torch.int32),
                                num_segments=2)
    ops.masked_neighbor_reduce(_t(z)[None], torch.ones(1, 7), trim=1)
    qkv = torch.zeros((1, 4, 2, 16))
    ops.flash_attention(qkv, qkv, qkv)
    assert ops.launch_counts() == {
        "saga_correct": 0, "partial_sqdist": 0, "weighted_sum": 0,
        "coordinate_median": 0, "trimmed_mean": 0, "partial_sqdist_segments": 0,
        "masked_neighbor_reduce": 0, "flash_attention": 0}


def test_route_counts_reset_and_stay_zero_on_the_cpu():
    """K2's and K7's per-route counts: the plain versions on the CPU launch
    nothing, and ``reset_launch_counts`` zeroes them with the rest."""
    from repro_torch.kernels import topology as tp
    wz.SQDIST_ROUTE_LAUNCHES["masked"] = 3
    tp.ROUTE_LAUNCHES["select"] = 2
    ops.reset_launch_counts()
    z, y, _ = _msgs(7, 30)
    ops.partial_sqdist(_t(z), _t(y), torch.ones(7))
    ops.partial_sqdist(_t(z[None]), _t(y[None]), torch.ones(1, 7))
    for trim in (0, 1, 3):
        ops.masked_neighbor_reduce(_t(z)[None], torch.ones(1, 7), trim=trim)
    assert wz.SQDIST_ROUTE_LAUNCHES == {"unmasked": 0, "masked": 0}
    assert tp.ROUTE_LAUNCHES == {"sum": 0, "select": 0, "rank": 0}


@pytest.mark.parametrize("kernel", ["saga_correct", "partial_sqdist",
                                    "weighted_sum"])
def test_kernels_reject_non_float32(kernel):
    """float32 and the bf16 wire's bfloat16 are the message dtypes; float16
    raises."""
    z, y, a = _msgs(3, 8)
    grad, table, avg, idx = _saga_inputs(3, 8)
    hf = lambda x: _t(x).to(torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        if kernel == "saga_correct":
            ops.saga_correct(hf(grad), hf(table), hf(avg), _t(idx))
        elif kernel == "partial_sqdist":
            ops.partial_sqdist(hf(z), _t(y))
        else:
            ops.weighted_sum(hf(z), _t(a))


def test_kernel_wrappers_refuse_cpu_tensors():
    z, y, a = _msgs(3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        wz.partial_sqdist_call(_t(z), _t(y))
    with pytest.raises(ValueError, match="CUDA"):
        wz.weighted_sum_call(_t(z), _t(a))
    grad, table, avg, idx = _saga_inputs(3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        sc.saga_correct_call(_t(grad), _t(table), _t(avg), _t(idx))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
