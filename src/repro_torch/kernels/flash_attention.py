"""K8: flash attention (port of ``repro/kernels/flash_attention.py``).

:func:`flash_attention_call` takes q (B, S, H, hd) and k, v (B, S, KV, hd)
in the model's layout, float32 or bfloat16, with H a multiple of KV, and
returns (B, S, H, hd): per query head h, ``softmax(mask(q k^T hd^-0.5)) v``
over the key/value head ``h // (H // KV)``.  Scores, softmax and sums are
float32; a masked score is -1e30 and the mask keeps keys ``kpos < S``,
in causal mode ``kpos <= qpos`` and, with a sliding ``window`` (causal
only; the reference's ``_sliding``), ``kpos > qpos - window``; the output
is divided by ``max(l, 1e-30)``.  It is written in q's dtype, or in float32 where the
caller asks.

It launches one of two CUDA kernels of ``csrc/flash_attention.cu``, both of
which read the grouped key/value heads in place (no repeated copy, unlike
the reference's ``ops.flash_attention``) and mask the ragged sequence edge
themselves (nothing padded); with a window both skip the key tiles wholly
below the band, as they skip those above the diagonal.  :func:`variant`
states which:

* ``"wgmma"`` -- bfloat16 inputs with hd 64 or 128 whose base and strides
  TMA can read (:func:`tma_aligned`): tensor cores, with p rounded to
  bfloat16 for ``p v`` (each weight moves by at most 2^-8 of itself, the
  output by at most 2^-8 max|v|).
* ``"simt"`` -- everything else (float32, other head dims, unaligned
  views): float32 arithmetic on the CUDA cores.

:data:`VARIANT_LAUNCHES` counts the launches of each; their sum is
``_build.LAUNCHES["flash_attention"]``.  :data:`WINDOW_LAUNCHES` counts
those of them that took a window.  :func:`flash_attention_plain` is
the same function in plain PyTorch (float32 scores, the same mask,
softmax, GQA by grouping the query heads), which the CPU path runs and the
card's checks compare against.

Training: :class:`FlashAttention` is K8 as a ``torch.autograd.Function``.
Its forward launches :func:`flash_attention_call`; its backward is
:func:`flash_attention_backward_plain`, plain PyTorch that recomputes the
float32 probabilities from q and k.  It runs under ``torch.func.grad`` and
``torch.func.vmap`` too (a vmapped dimension folded into B), which is how
the training drivers take per-worker gradients.  The reference has no backward kernel
either -- its Pallas K8 has no ``custom_vjp``, and its training
differentiates the jnp ``_flash`` -- so none is written here; a
hand-written backward kernel is queued (ROADMAP.md Queue B, K8).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65_535
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_HEAD_DIMS = (64, 128)
VARIANTS = ("wgmma", "simt")
_ENTRY = {"wgmma": "flash_attention_fwd_wgmma", "simt": "flash_attention_fwd"}

_SIGNATURES = {
    name: [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    for name in _ENTRY.values()
}

# Launches per route, and of each route with a sliding window (reset with
# the others by ops.reset_launch_counts).
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)
WINDOW_LAUNCHES = dict.fromkeys(VARIANTS, 0)


def variant(dtype: torch.dtype, hd: int, aligned: bool) -> str:
    """The kernel that serves q's ``dtype`` and head dim ``hd``: "wgmma"
    for bfloat16 with hd 64 or 128 when TMA can read q, k and v
    (``aligned``, :func:`tma_aligned`), else "simt"."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and aligned:
        return "wgmma"
    return "simt"


def tma_aligned(*tensors: torch.Tensor) -> bool:
    """True when every tensor's base is 16-byte aligned and each of its
    strides over (B, S, heads) whose size is above 1 is a positive multiple
    of 16 bytes, as a TMA tensor map needs."""
    for t in tensors:
        if t.data_ptr() % 16:
            return False
        for size, stride in zip(t.shape[:3], t.stride()[:3]):
            if size > 1 and (stride <= 0 or stride * t.element_size() % 16):
                return False
    return True


def _map_strides(t: torch.Tensor) -> list[int]:
    """t's element strides over (B, S, heads), a dimension of size 1 given
    its contiguous stride (any stride addresses it; the tensor map needs a
    valid one)."""
    out = []
    for i, (size, stride) in enumerate(zip(t.shape[:3], t.stride()[:3])):
        out.append(stride if size > 1 else math.prod(t.shape[i + 1:]))
    return out


def check_window(window: int | None, causal: bool) -> None:
    """A window is None, or an int >= 1 with ``causal`` (the reference
    slides its window over causal self-attention only)."""
    if window is None:
        return
    if isinstance(window, bool) or not isinstance(window, int) or window < 1:
        raise ValueError(f"flash_attention: window {window!r} is neither None "
                         "nor an int >= 1")
    if not causal:
        raise ValueError("flash_attention: a window needs causal=True")


def window_pairs(s: int, window: int | None) -> int:
    """The (query, key) pairs one (b, h) of causal attention attends:
    S (S + 1) / 2, or sum_q min(q + 1, window) with a window."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q (B, S, H, hd), k and v (B, S, KV, hd), H a multiple of KV,
    1 <= hd <= 256, one dtype (float32 or bfloat16) and one device.  Raises
    on anything else."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         "(B, S, H, hd) and two (B, S, KV, hd)")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd) or kv == 0 or h % kv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B, S and hd; H a multiple "
                         "of KV)")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} is outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if q.dtype not in _TYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: inputs lie on different devices")


def _mask(s: int, causal: bool, window: int | None,
          device: torch.device) -> torch.Tensor | None:
    """(S, S) True where the key (column) is masked for the query (row)."""
    if not causal:
        return None
    pos = torch.arange(s, device=device)
    masked = pos[None, :] > pos[:, None]
    if window is not None:
        masked = masked | (pos[None, :] <= pos[:, None] - window)
    return masked


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, out_dtype: torch.dtype | None = None,
                          window: int | None = None) -> torch.Tensor:
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, hd)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * (hd ** -0.5)
    masked = _mask(s, causal, window, q.device)
    if masked is not None:
        sc = sc.masked_fill(masked, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(b, s, h, hd).to(out_dtype or q.dtype)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   dout: torch.Tensor, causal: bool,
                                   window: int | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The gradients (dq, dk, dv), in q's, k's and v's dtypes, of the
    attention ``out = softmax(mask(q k^T c)) v`` (c = hd^-0.5, the mask
    and the GQA grouping of :func:`flash_attention_plain`, ``window``
    included) given ``dout``.
    The float32 probabilities P are recomputed; then dV = P^T dO, dS =
    P o (dO V^T - rowsum(dO o O)), dQ = c dS K, dK = c dS^T Q, dK and dV
    summed over the query heads of each key/value head.  One batch row
    and one key/value head at a time, so at most (H / KV, S, S) float32
    scores exist at once; the pieces are stacked, never written into a
    buffer, so the function also runs on ``torch.func.vmap``'s batched
    tensors (the backward of :class:`FlashAttention` under ``vmap(grad)``)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    masked = _mask(s, causal, window, q.device)
    dqs, dks, dvs = [], [], []
    for bi in range(b):
        dq_b, dk_b, dv_b = [], [], []
        for g in range(kv):
            heads = slice(g * rep, (g + 1) * rep)
            qg = q[bi, :, heads].float().transpose(0, 1)          # (rep, S, hd)
            og = out[bi, :, heads].float().transpose(0, 1)
            dog = dout[bi, :, heads].float().transpose(0, 1)
            kg = k[bi, :, g].float()                               # (S, hd)
            vg = v[bi, :, g].float()
            sc = torch.matmul(qg, kg.T) * scale                    # (rep, S, S)
            if masked is not None:
                sc = sc.masked_fill(masked, NEG_INF)
            p = torch.softmax(sc, dim=-1)
            dv_b.append(torch.sum(torch.matmul(p.transpose(1, 2), dog), 0))
            dp = torch.matmul(dog, vg.T)                           # (rep, S, S)
            ds = p * (dp - torch.sum(dog * og, dim=-1, keepdim=True))
            dq_b.append((torch.matmul(ds, kg) * scale).transpose(0, 1))
            dk_b.append(torch.sum(torch.matmul(ds.transpose(1, 2), qg),
                                  0) * scale)
        dqs.append(torch.cat(dq_b, dim=1))                         # (S, H, hd)
        dks.append(torch.stack(dk_b, dim=1))                       # (S, KV, hd)
        dvs.append(torch.stack(dv_b, dim=1))
    dq, dk, dv = torch.stack(dqs), torch.stack(dks), torch.stack(dvs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """K8 for training: the forward launches the kernel
    (:func:`flash_attention_call`, its route by :func:`variant`), the
    backward runs :func:`flash_attention_backward_plain` on the saved q, k,
    v and output.

    It runs under ``torch.func`` as under autograd: the context is set up
    apart from the forward (``setup_context``), so ``torch.func.grad``
    differentiates it, and :meth:`vmap` folds a vmapped dimension into B
    (``(N, B, S, ...)`` -> ``(N * B, S, ...)``), launches the kernel once
    on the folded batch and unfolds the output, so ``vmap(grad(loss))``
    over N workers launches K8 once a layer, never its plain version.  The
    backward is plain PyTorch and is batched by ``vmap`` like any other
    code.  ``window`` (None or an int >= 1, causal only) passes through
    all three unchanged."""

    @staticmethod
    def forward(q, k, v, causal: bool, window: int | None):
        return flash_attention_call(q, k, v, causal, window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.causal, ctx.window = inputs
        ctx.save_for_backward(q, k, v, output)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_plain(q, k, v, out, dout,
                                                    ctx.causal, ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal: bool, window: int | None):
        n = info.batch_size

        def fold(t, dim):
            t = (t.unsqueeze(0).expand((n,) + tuple(t.shape)) if dim is None
                 else t.movedim(dim, 0))
            return t.reshape((n * t.shape[1],) + tuple(t.shape[2:]))

        out = FlashAttention.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                   fold(v, in_dims[2]), causal, window)
        return out.reshape((n, -1) + tuple(out.shape[1:])), 0


def flash_attention_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, out_dtype: torch.dtype | None = None,
                         *, route: str | None = None,
                         window: int | None = None) -> torch.Tensor:
    """(B, S, H, hd) attention on the card; ``out_dtype`` is q's dtype
    (default) or float32.  Each of q, k, v may have any strides over
    (B, S, heads) with a contiguous last dimension.  ``route`` None takes
    :func:`variant`'s kernel; "simt" takes the SIMT kernel whatever the
    inputs (to time it against the wgmma kernel).  ``window``: None, or
    the sliding window (>= 1, causal only) both kernels apply."""
    check_inputs(q, k, v)
    check_window(window, causal)
    if route not in (None, "simt"):
        raise ValueError(f"flash_attention: route {route!r} is neither None nor 'simt'")
    if q.device.type != "cuda":
        raise ValueError("flash_attention: tensors must lie on a CUDA device")
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"flash_attention: out_dtype {out_dtype} is neither "
                        f"{q.dtype} nor float32")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dimension of q, k and v "
                         "must be contiguous")
    b, s, h, hd = q.shape
    if b > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"flash_attention: B={b} or H={h} exceeds {MAX_GRID_YZ}")
    chosen = route or variant(q.dtype, hd, tma_aligned(q, k, v))
    out = torch.empty((b, s, h, hd), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention", _SIGNATURES)
    strides = q.stride()[:3], k.stride()[:3], v.stride()[:3]
    if chosen == "wgmma":
        strides = _map_strides(q), _map_strides(k), _map_strides(v)
    with torch.cuda.device(q.device):
        rc = getattr(lib, _ENTRY[chosen])(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _TYPE_CODES[q.dtype], _TYPE_CODES[out_dtype], b, s, h, k.shape[2],
            hd, *strides[0], *strides[1], *strides[2], int(causal),
            int(window or 0), ctypes.c_float(hd ** -0.5),
            ctypes.c_void_p(_build.stream_of(q)))
    _build.check(lib, rc, f"flash_attention ({chosen})")
    _build.LAUNCHES["flash_attention"] += 1
    VARIANT_LAUNCHES[chosen] += 1
    if window is not None:
        WINDOW_LAUNCHES[chosen] += 1
    return out
