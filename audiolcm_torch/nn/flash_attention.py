"""Flash attention: the CUDA kernels of K3 (`csrc/flash_attention.cu`),
their plain PyTorch version, and the bf16 kernel's blockwise algorithm in
torch. Self-attention, and cross-attention whose keys and values have a
length of their own (the Flag DiT's caption branch).

It replaces the TPU kernel `audiolcm_tpu/nn/pallas_attention.py:flash_attention`.

  * `flash_attention` — the wrapper. A CUDA tensor launches a kernel (or
    raises): bf16 goes to the tensor-core kernel, through 16-byte `cp.async`
    loads or element-wise loads as `pick_route` decides from the strides;
    f32 goes to the CUDA-core kernel. A CPU tensor runs
    `flash_attention_plain`.
  * `flash_attention_plain` — the same function in plain torch: q, k, v
    widened to f32, q scaled before the dot, f32 softmax and P.V, output in
    q's dtype. Used by the CPU tests and by chip_smoke's comparison.
  * `flash_attention_blocked` — the tensor-core kernel's algorithm (64-key
    tiles, one online-softmax step per tile, scale on the f32 logits, masked
    tail, bf16 P split into hi + lo, division by max(l, 1e-30) at the end)
    in torch, over k's own length Tk, so the CPU tests hold the kernel's decomposition against the
    JAX package.
  * `attention_auto` — the JAX dispatcher: the kernel on the card, the
    einsum `dot_product_attention` elsewhere.

Layout: q (B, H, T, D), k and v (B, H, Tk, D), in any strides; the result
is (B, H, T, D). Every launch counts in the recorder (`obs`) under its
route, `flash_attention.tc` or `.f32`, and a launch whose keys number other
than its queries also under `CROSS_COUNTER`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audiolcm_torch import obs

BLOCK_K = 64  # keys per shared-memory tile; must match csrc/flash_attention.cu
MAX_D = 128
NEG_INF = -1e30
# route codes of csrc/flash_attention.cu's flash_attention_launch
ROUTES = {"cuda_core": 0, "tc_vec": 1, "tc_elementwise": 2}
CROSS_COUNTER = "flash_attention.cross"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """q (B, H, T, D), k, v (B, H, Tk, D) -> (B, H, T, D): f32 inside, output
    in q's dtype."""
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                            block_k: int = BLOCK_K, chunk: int | None = None,
                            split_p: bool = True) -> torch.Tensor:
    """What csrc/flash_attention.cu's tensor-core kernel computes, in torch:
    keys in tiles of `block_k`, one online-softmax step per tile (`chunk`
    keys per step, default the whole tile); per step the f32 logits
    (q . k) * scale, the running max m, alpha = exp(m_old - m_new),
    l = alpha*l + sum(p) over the unrounded f32 p and acc = alpha*acc + p.v,
    where for bf16 inputs p enters P.V as bf16(p) + bf16(p - bf16(p))
    (`split_p=False`: one bf16 p); keys past Tk are masked to -1e30 and steps
    wholly past Tk skipped; out = acc / max(l, 1e-30) in q's dtype. For f32
    inputs the card runs the CUDA-core kernel instead, whose steps are
    16-key chunks over a pre-scaled q: the same sums in another order."""
    t = k.shape[-2]
    step = chunk or block_k
    qf, kf, vf = q.float(), k.float(), v.float()
    bf16_p = q.dtype == torch.bfloat16
    acc = torch.zeros_like(qf)
    m = qf.new_full(qf.shape[:-1] + (1,), NEG_INF)
    l = torch.zeros_like(m)
    for k0 in range(0, t, block_k):
        end = min(k0 + block_k, t)
        for lo in range(k0, end, step):
            # a tile's masked keys (-1e30) change neither its max nor, at
            # p = exp(-1e30 - m) = 0, its sums: only its real keys count
            hi = min(lo + step, end)
            s = torch.matmul(qf, kf[..., lo:hi, :].transpose(-1, -2)) * scale
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            vt = vf[..., lo:hi, :]
            if bf16_p:
                p_hi = p.bfloat16().float()
                pv = torch.matmul(p_hi, vt)
                if split_p:
                    pv = pv + torch.matmul((p - p_hi).bfloat16().float(), vt)
            else:
                pv = torch.matmul(p, vt)
            acc = acc * alpha + pv
            l = alpha * l + p.sum(-1, keepdim=True)
            m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _vectorizable(x: torch.Tensor) -> bool:
    """The 16-byte route's preconditions on one (B, H, T, D) tensor:
    d-stride 1, D % 8 == 0, a 16-byte aligned base and b/h/t strides in
    whole 16-byte units wherever the dimension has more than one entry."""
    (b, h, t, d), (sb, sh, st, sd) = x.shape, x.stride()
    return (d % 8 == 0 and sd == 1 and x.data_ptr() % 16 == 0 and (b == 1 or sb % 8 == 0)
            and (h == 1 or sh % 8 == 0) and (t == 1 or st % 8 == 0))


def pick_route(*tensors: torch.Tensor) -> str:
    """The kernel that `flash_attention` launches for these tensors (q, k, v
    and, in `_launch`, out): 'cuda_core' for f32; for bf16 'tc_vec' (the
    tensor-core kernel with cp.async loads) when every tensor is
    `_vectorizable`, else 'tc_elementwise' (the same kernel, element-wise
    loads and stores through the strides)."""
    if tensors[0].dtype == torch.float32:
        return "cuda_core"
    return "tc_vec" if all(_vectorizable(x) for x in tensors) else "tc_elementwise"


@functools.lru_cache(maxsize=None)
def _library():
    """The kernels' library, built from csrc/flash_attention.cu."""
    from audiolcm_torch.build import build

    lib = ctypes.CDLL(str(build("flash_attention")))
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    b, h, t, d = q.shape
    tk = k.shape[-2]
    # written in the (B, T, H, D) layout the output projection reads, so
    # out.transpose(1, 2).reshape(B, T, H*D) is a view
    out = torch.empty(b, t, h, d, device=q.device, dtype=q.dtype).transpose(1, 2)
    route = pick_route(q, k, v, out)
    strides = (ctypes.c_longlong * 16)(*(s for x in (q, k, v, out) for s in x.stride()))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, t, tk,
            d, float(scale), ROUTES[route], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({route}): CUDA error {rc}")
    obs.count("flash_attention.f32" if route == "cuda_core" else "flash_attention.tc")
    if tk != t:
        obs.count(CROSS_COUNTER)
    return out


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q (B, H, T, D), k and v (B, H, Tk, D) -> (B, H, T, D); softmax over
    the Tk keys in f32 (Tk = T for self-attention).

    On a CUDA tensor this launches an sm_90a kernel (bf16: tensor cores,
    f32: CUDA cores) or raises; on a CPU tensor it runs the plain version. q, k and v may be strided views (head
    splits, chunks of a fused qkv projection): the kernel reads them in
    place.

    The kernel has no backward, in this package or the JAX one (whose
    trainers build the DiT with use_flash=False, as the port's do): on a
    CUDA tensor that autograd would record it raises, since the ctypes
    launch would silently cut the gradient."""
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[:2] != k.shape[:2]
            or q.shape[-1] != k.shape[-1]):
        raise ValueError(f"q must be one (B, H, T, D) shape and k, v one (B, H, Tk, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if records_grad(q, k, v):
        raise RuntimeError("the flash attention kernel has no backward: call it under "
                           "torch.no_grad() or inference_mode, or build the DiT with "
                           "use_flash=False for training")
    if (q.shape[-1] > MAX_D or q.shape[0] * q.shape[1] > 65535 or q.shape[-2] < 1
            or k.shape[-2] < 1):
        raise ValueError(f"the flash attention kernel takes D <= {MAX_D}, B*H <= 65535 "
                         f"and T, Tk >= 1, got {tuple(q.shape)}, {tuple(k.shape)}")
    return _launch(q, k, v, scale)


def attention_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Dispatch as the JAX package does: the kernel on the card, the einsum
    path elsewhere."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, scale)
    from audiolcm_torch.nn.attention import dot_product_attention

    return dot_product_attention(q, k, v, scale)
