"""Flash self-attention: the CUDA kernel K3 (`csrc/flash_attention.cu`), its
plain PyTorch version, and the kernel's blockwise algorithm in torch.

It replaces the TPU kernel `audiolcm_tpu/nn/pallas_attention.py:flash_attention`.

  * `flash_attention` — the wrapper. A CUDA tensor launches the kernel (or
    raises); a CPU tensor runs `flash_attention_plain`.
  * `flash_attention_plain` — the same function in plain torch: q, k, v
    widened to f32, q scaled before the dot, f32 softmax and P.V, output in
    q's dtype. Used by the CPU tests and by chip_smoke's comparison.
  * `flash_attention_blocked` — the kernel's own algorithm (key tiles,
    online softmax over chunks of keys, masked tail, division by
    max(l, 1e-30) at the end) in torch, so the CPU tests hold the kernel's
    decomposition against the JAX package.
  * `attention_auto` — the JAX dispatcher: the kernel on the card, the
    einsum `dot_product_attention` elsewhere.

Layout: q, k, v (B, H, T, D) in any strides; the result is (B, H, T, D).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Kernel launches since the last reset (chip_smoke sets it to 0 around a run).
LAUNCHES = 0

BLOCK_K = 64  # keys per shared-memory tile; must match csrc/flash_attention.cu
CHUNK = 16  # keys per online-softmax step; must match csrc/flash_attention.cu
MAX_D = 128
NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """(B, H, T, D) x3 -> (B, H, T, D): f32 inside, output in q's dtype."""
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                            block_k: int = BLOCK_K, chunk: int = CHUNK) -> torch.Tensor:
    """What csrc/flash_attention.cu computes, in torch: keys in tiles of
    `block_k`, each tile in chunks of `chunk` keys; per chunk the running
    max m, the rescale alpha = exp(m_old - m_new), l = alpha*l + sum(p) and
    acc = alpha*acc + p.v; keys past T masked to -1e30 and chunks wholly
    past T skipped; out = acc / max(l, 1e-30) in q's dtype."""
    t = q.shape[-2]
    qs = q.float() * scale
    kf, vf = k.float(), v.float()
    acc = torch.zeros_like(qs)
    m = qs.new_full(qs.shape[:-1] + (1,), NEG_INF)
    l = torch.zeros_like(m)
    for k0 in range(0, t, block_k):
        nk = min(block_k, t - k0)
        for c0 in range(0, nk, chunk):
            # a chunk's masked slots (-1e30) change neither its max nor,
            # at p = exp(-1e30 - m) = 0, its sums: only its real keys count
            lo = k0 + c0
            n = min(chunk, t - lo)
            s = torch.matmul(qs, kf[..., lo:lo + n, :].transpose(-1, -2))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            acc = acc * alpha + torch.matmul(p, vf[..., lo:lo + n, :])
            l = alpha * l + p.sum(-1, keepdim=True)
            m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    from audiolcm_torch.build import build

    lib = ctypes.CDLL(str(build("flash_attention")))
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    global LAUNCHES
    b, h, t, d = q.shape
    # written in the (B, T, H, D) layout the output projection reads, so
    # out.transpose(1, 2).reshape(B, T, H*D) is a view
    out = torch.empty(b, t, h, d, device=q.device, dtype=q.dtype).transpose(1, 2)
    strides = (ctypes.c_longlong * 16)(*(s for x in (q, k, v, out) for s in x.stride()))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, t, d,
            float(scale), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q, k, v: (B, H, T, D) -> (B, H, T, D); softmax over keys in f32.

    On a CUDA tensor this launches the sm_90a kernel or raises; on a CPU
    tensor it runs the plain version. q, k and v may be strided views (head
    splits, chunks of a fused qkv projection): the kernel reads them in
    place."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be one (B, H, T, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if q.shape[-1] > MAX_D or q.shape[0] * q.shape[1] > 65535 or q.shape[-2] < 1:
        raise ValueError(f"the flash attention kernel takes D <= {MAX_D}, B*H <= 65535 "
                         f"and T >= 1, got {tuple(q.shape)}")
    return _launch(q, k, v, scale)


def attention_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Dispatch as the JAX package does: the kernel on the card, the einsum
    path elsewhere."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, scale)
    from audiolcm_torch.nn.attention import dot_product_attention

    return dot_product_attention(q, k, v, scale)
