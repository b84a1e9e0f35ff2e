"""The routed experts of a mixture-of-experts layer: a dispatch sorted on
the device, the grouped SwiGLU kernel K7 (Triton), its plain per-expert
loop, and the kernel's walk over the dispatch in torch.

K7 replaces no Pallas kernel: the JAX package has no expert layer. It was
added for the DeepSeek-V3-family caption tower (`models/moe_llm.py`), whose
expert layers a per-expert loop cannot serve from a CUDA graph: a loop over
`nonzero()` or over expert counts read back to the host syncs, and a
capture cannot hold a sync.

    out = residual + shared + sum_k w[t, k] * down_e(silu(gate_e x_t) * up_e x_t),  e = idx[t, k]

  * `dispatch` — the T x k assignments sorted by expert on the device with
    no host sync: (token of each sorted row, the sorted row of each
    assignment, each expert's first row), from a one-hot cumulative count,
    stable (rows of an expert in token order); `dispatch_on_card`, K7's
    first kernel, computes the same. No token is dropped: the buffer holds all
    T x k rows, whatever the split over experts.
  * `routed_experts` — K7, four launches a layer:
      - dispatch: `dispatch` in one program (per expert a cumulative sum
        over the assignments), no host sync;
      - gate-up: one program per (expert, `GATE_UP["BN"]` columns of the
        expert width): x's rows of its tokens gathered, gate and up
        products with f32 sums, silu(gate) * up rounded to bf16 into the
        sorted rows of a (T k, I) buffer, one M tile of `BM` rows after
        another (each re-reads the program's weights: an expert that gets
        many rows, as uneven routing gives, costs more than one read);
      - down: one program per (expert, `DOWN["BN"]` output columns): the
        rows' down products in f32 into a (T k, d) buffer;
      - combine: one program per (token, `COMBINE["BN"]` columns):
        residual + shared + its k rows times their routing weights, in
        slot order (no atomics, so the sum's order, and the result, is the
        same at every run), rounded once to bf16.
    The routing weight and the combine are K7's; the shared experts run
    through cuBLAS (`models/moe_llm.py`).
  * `routed_experts_plain` — a Python loop over the experts (HF's
    `DeepseekV3MoE.moe`), the route off the card, in f32 and under
    autograd, and the kernel tests' yardstick.
  * `routed_experts_walk` — K7's algorithm in torch (rows per expert from
    the dispatch's offsets, the combine's order), which the CPU tests hold
    against the plain loop.
  * `stack` — an expert projection's weights as one (E, N, K) tensor; made
    once per weight version at the pipeline's build (`MoE.stacked_weights`).

Bound on this card: at batch 1 (128 tokens x 6 = 768 rows over 64 experts)
every expert receives tokens, so a layer reads all of its experts' weights,
64 x 3 x 1408 x 2048 bf16 = 1.107 GB (0.330 ms at 3.35 TB/s), against
2 x 768 x 3 x 1408 x 2048 = 13.3 GFLOP (13.4 us at 989 TFLOP/s): HBM
bandwidth binds it by 25x. The design streams each expert's weights
through 1408 (gate-up) and 2048 (down) programs, with Triton's pipelined
loads under the tensor-core products.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence

import torch
import torch.nn.functional as F

from audiolcm_torch import obs

COUNTER = "moe_experts"  # one per K7 launch, four per expert layer
BM_SMALL, BM_LARGE = 16, 64  # rows per M tile: up to ~24 rows an expert, and above
# gate-up: expert-width columns per program (BN), K step (BK), Triton's launch
GATE_UP = dict(BN=64, BK=128, num_warps=4, num_stages=4)
# down: output columns per program (BN), K step (BK), Triton's launch
DOWN = dict(BN=64, BK=128, num_warps=4, num_stages=4)
COMBINE = dict(BN=512, num_warps=4)  # combine: output columns per program
DISPATCH = dict(BA=1024, num_warps=4)  # dispatch: assignments per step of a program
TRITON_CACHE = Path(__file__).resolve().parent.parent / "_build" / "triton"


def takes(x: torch.Tensor) -> bool:
    """Whether K7 runs the routed experts of x (T, d)."""
    return x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()


def _back_to_back(ts: Sequence[torch.Tensor]) -> bool:
    t0 = ts[0]
    step = t0.numel() * t0.element_size()
    return (t0.is_contiguous() and all(
        t.is_contiguous() and t.shape == t0.shape and t.dtype == t0.dtype
        and t.untyped_storage().data_ptr() == t0.untyped_storage().data_ptr()
        and t.data_ptr() == t0.data_ptr() + i * step for i, t in enumerate(ts)))


def stack(linears) -> torch.Tensor:
    """The weights of `linears` (each (N, K)) as one (E, N, K) tensor: a view
    where they already lie back to back in one buffer, else one copy, which
    each linear's weight then becomes a view of (so the layer holds its
    experts once)."""
    ws = [m.weight for m in linears]
    if _back_to_back(ws):
        t0 = ws[0]
        return torch.as_strided(t0, (len(ws),) + tuple(t0.shape),
                                (t0.numel(),) + t0.stride(), t0.storage_offset())
    out = torch.stack([w.detach() for w in ws])
    for i, m in enumerate(linears):
        m.weight = torch.nn.Parameter(out[i], requires_grad=m.weight.requires_grad)
    return out


def dispatch(idx: torch.Tensor, n_experts: int):
    """idx (T, k) -> (token of each sorted row (T k,) int32, the sorted row of
    each assignment (T, k) int32, each expert's first row (E + 1,) int32).
    Device work only: no host sync."""
    flat = idx.reshape(-1)
    n = flat.numel()
    onehot = (flat[:, None] == torch.arange(n_experts, device=flat.device)[None]).int()
    ranks = onehot.cumsum(0)  # (n, E): rows of each expert up to and including this one
    offsets = torch.zeros(n_experts + 1, dtype=torch.int64, device=flat.device)
    offsets[1:] = ranks[-1].cumsum(0)
    pos = offsets[flat] + ranks.gather(1, flat[:, None])[:, 0] - 1
    tok = torch.empty(n, dtype=torch.int64, device=flat.device).scatter_(
        0, pos, torch.arange(n, device=flat.device) // idx.shape[1])
    return tok.int(), pos.view(idx.shape).int(), offsets.int()


def routed_experts_plain(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                         experts: Sequence[tuple]) -> torch.Tensor:
    """x (T, d), idx and w (T, k), experts [(gate, up, down)] -> the routed
    sum (T, d) f32: each expert's SwiGLU in x's dtype over its tokens,
    times their weights, summed in f32."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e, (wg, wu, wd) in enumerate(experts):
        tok, slot = torch.where(idx == e)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        y = F.linear(F.silu(F.linear(xe, wg)) * F.linear(xe, wu), wd)
        out.index_add_(0, tok, y.float() * w[tok, slot, None])
    return out


def routed_experts_walk(x, idx, w, stacked, residual, shared) -> torch.Tensor:
    """K7's algorithm in torch: the dispatch's rows per expert, gate-up with
    h rounded to x's dtype, the down products per sorted row in f32, then
    per token residual + shared and its rows' weighted products in slot
    order, rounded once to x's dtype."""
    wg, wu, wd = stacked
    tok, pos, offsets = dispatch(idx, wg.shape[0])
    y = torch.zeros((tok.numel(), x.shape[1]), dtype=torch.float32, device=x.device)
    bounds = offsets.tolist()
    for e in range(wg.shape[0]):
        rows = slice(bounds[e], bounds[e + 1])
        xe = x[tok[rows].long()].float()
        h = (F.silu(xe @ wg[e].float().T) * (xe @ wu[e].float().T)).to(x.dtype)
        y[rows] = h.float() @ wd[e].float().T
    acc = residual.float() + shared.float()
    for slot in range(idx.shape[1]):
        acc = acc + w[:, slot, None].float() * y[pos[:, slot].long()]
    return acc.to(x.dtype)


def dispatch_on_card(idx: torch.Tensor, n_experts: int):
    """`dispatch` by K7's first kernel (one launch), for idx on the card."""
    n_tok, k = idx.shape
    tok = torch.empty(n_tok * k, dtype=torch.int32, device=idx.device)
    pos = torch.empty((n_tok, k), dtype=torch.int32, device=idx.device)
    offsets = torch.empty(n_experts + 1, dtype=torch.int32, device=idx.device)
    _kernels()[0][(1,)](idx.contiguous(), tok, pos, offsets, n_tok * k, E=n_experts, K=k,
                        **DISPATCH)
    obs.count(COUNTER)
    return tok, pos, offsets


@torch.no_grad()
def routed_experts(x, idx, w, stacked, residual, shared) -> torch.Tensor:
    """x, residual, shared (T, d) bf16 on the card; idx, w (T, k); stacked
    (gate (E, I, d), up (E, I, d), down (E, d, I)) -> residual + shared +
    the routed sum (T, d) bf16, through K7 (four launches)."""
    wg, wu, wd = stacked
    n_exp, inter, d = wg.shape
    if not takes(x):
        raise ValueError(f"K7 takes bf16 on the card without autograd; got {x.dtype} on "
                         f"{x.device}")
    for t, shape in ((wu, wg.shape), (wd, (n_exp, d, inter))):
        if tuple(t.shape) != tuple(shape) or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"K7's weights: want {tuple(shape)} contiguous {x.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not wg.is_contiguous() or x.shape[1] != d:
        raise ValueError("K7's gate weights must be contiguous (E, I, d) over x (T, d)")
    x, residual, shared = (t.contiguous() for t in (x, residual, shared))
    tok, pos, offsets = dispatch_on_card(idx, n_exp)
    n_rows, (n_tok, k) = tok.numel(), idx.shape
    bm = BM_SMALL if n_rows <= 24 * n_exp else BM_LARGE
    _, gate_up, down, combine = _kernels()
    h = torch.empty((n_rows, inter), dtype=x.dtype, device=x.device)
    gate_up[(n_exp, -(-inter // GATE_UP["BN"]))](x, tok, offsets, wg, wu, h, D=d, I=inter, BM=bm,
                                                  **GATE_UP)
    obs.count(COUNTER)
    y = torch.empty((n_rows, d), dtype=torch.float32, device=x.device)
    down[(n_exp, -(-d // DOWN["BN"]))](h, offsets, wd, y, D=d, I=inter, BM=bm, **DOWN)
    obs.count(COUNTER)
    out = torch.empty_like(x)
    combine[(n_tok, -(-d // COMBINE["BN"]))](y, pos, w.float().contiguous(), residual, shared,
                                            out, D=d, K=k, **COMBINE)
    obs.count(COUNTER)
    return out


_KERNELS = None


def _kernels():
    """K7's four Triton kernels, defined at first use (this module imports
    without Triton; the compiled kernels are cached under
    `audiolcm_torch/_build/triton` unless TRITON_CACHE_DIR says where)."""
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_CACHE))
    import triton
    import triton.language as tl

    @triton.jit
    def k7_dispatch(idx_ptr, tok_ptr, pos_ptr, off_ptr, A, E: tl.constexpr, K: tl.constexpr,
                    BA: tl.constexpr):
        """`dispatch` in one program: per expert, its assignments' ranks by a
        cumulative sum over the flat idx in chunks of BA."""
        base = tl.zeros((), dtype=tl.int32)
        for e in range(E):
            tl.store(off_ptr + e, base)
            for a0 in range(0, A, BA):
                j = a0 + tl.arange(0, BA)
                mine = (tl.load(idx_ptr + j, mask=j < A, other=-1) == e).to(tl.int32)
                p = base + tl.cumsum(mine, axis=0) - 1
                tl.store(pos_ptr + j, p, mask=mine > 0)
                tl.store(tok_ptr + p, j // K, mask=mine > 0)
                base += tl.sum(mine, axis=0)
        tl.store(off_ptr + E, base)

    @triton.jit
    def k7_gate_up(x_ptr, tok_ptr, off_ptr, wg_ptr, wu_ptr, h_ptr, D: tl.constexpr,
                   I: tl.constexpr, BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
        e = tl.program_id(0)
        cols = tl.program_id(1) * BN + tl.arange(0, BN)
        cmask = cols < I
        ks = tl.arange(0, BK)
        start = tl.load(off_ptr + e)
        end = tl.load(off_ptr + e + 1)
        w_off = e.to(tl.int64) * I * D + cols[None, :].to(tl.int64) * D
        for m0 in range(start, end, BM):
            rows = m0 + tl.arange(0, BM)
            rmask = rows < end
            tok = tl.load(tok_ptr + rows, mask=rmask, other=0).to(tl.int64)
            acc_g = tl.zeros((BM, BN), dtype=tl.float32)
            acc_u = tl.zeros((BM, BN), dtype=tl.float32)
            for k0 in range(0, D, BK):
                kk = k0 + ks
                a = tl.load(x_ptr + tok[:, None] * D + kk[None, :],
                            mask=rmask[:, None] & (kk[None, :] < D), other=0.0)
                wmask = (kk[:, None] < D) & cmask[None, :]
                bg = tl.load(wg_ptr + w_off + kk[:, None], mask=wmask, other=0.0)
                bu = tl.load(wu_ptr + w_off + kk[:, None], mask=wmask, other=0.0)
                acc_g = tl.dot(a, bg, acc_g)
                acc_u = tl.dot(a, bu, acc_u)
            hval = acc_g / (1.0 + tl.exp(-acc_g)) * acc_u
            tl.store(h_ptr + rows[:, None].to(tl.int64) * I + cols[None, :],
                     hval.to(h_ptr.dtype.element_ty), mask=rmask[:, None] & cmask[None, :])

    @triton.jit
    def k7_down(h_ptr, off_ptr, wd_ptr, y_ptr, D: tl.constexpr, I: tl.constexpr,
                BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
        e = tl.program_id(0)
        cols = tl.program_id(1) * BN + tl.arange(0, BN)
        cmask = cols < D
        ks = tl.arange(0, BK)
        start = tl.load(off_ptr + e)
        end = tl.load(off_ptr + e + 1)
        w_off = e.to(tl.int64) * D * I + cols[None, :].to(tl.int64) * I
        for m0 in range(start, end, BM):
            rows = m0 + tl.arange(0, BM)
            rmask = rows < end
            acc = tl.zeros((BM, BN), dtype=tl.float32)
            for k0 in range(0, I, BK):
                kk = k0 + ks
                a = tl.load(h_ptr + rows[:, None].to(tl.int64) * I + kk[None, :],
                            mask=rmask[:, None] & (kk[None, :] < I), other=0.0)
                b = tl.load(wd_ptr + w_off + kk[:, None],
                            mask=(kk[:, None] < I) & cmask[None, :], other=0.0)
                acc = tl.dot(a, b, acc)
            tl.store(y_ptr + rows[:, None].to(tl.int64) * D + cols[None, :], acc,
                     mask=rmask[:, None] & cmask[None, :])

    @triton.jit
    def k7_combine(y_ptr, pos_ptr, w_ptr, res_ptr, sh_ptr, out_ptr, D: tl.constexpr,
                   K: tl.constexpr, BN: tl.constexpr):
        t = tl.program_id(0).to(tl.int64)
        cols = tl.program_id(1) * BN + tl.arange(0, BN)
        cmask = cols < D
        acc = (tl.load(res_ptr + t * D + cols, mask=cmask, other=0.0).to(tl.float32)
               + tl.load(sh_ptr + t * D + cols, mask=cmask, other=0.0).to(tl.float32))
        for slot in tl.static_range(K):  # the token's rows in slot order
            row = tl.load(pos_ptr + t * K + slot).to(tl.int64)
            acc += tl.load(w_ptr + t * K + slot) * tl.load(y_ptr + row * D + cols, mask=cmask,
                                                           other=0.0)
        tl.store(out_ptr + t * D + cols, acc.to(out_ptr.dtype.element_ty), mask=cmask)

    _KERNELS = (k7_dispatch, k7_gate_up, k7_down, k7_combine)
    return _KERNELS
