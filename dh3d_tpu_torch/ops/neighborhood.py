"""Neighbourhood reductions and their transposes: kernels C, D, E and F
(`csrc/neighborhood.cu`) and their plain versions.

  weighted_sum:  out[b, n, p*C + c] = sum_k w[b, n, k, p] * f[b, nbh[b, n, k], c]
  neighbor_max:  val[b, n, c] = max_k f[b, nbh[b, n, k], c],
                 arg[b, n, c] = nbh[b, n, k*], k* the lowest k attaining it

Both are `torch.autograd.Function`s (`WeightedSum`, `NeighborMax`).  The
features get a gradient; the weights and the indices get none, as in the
JAX VJPs (`banded_pallas.py:25-29`), which give the weights a zero
cotangent and the positions none.  Their backwards are kernels too:
  E  weighted_sum_backward:  dfeat[b, j, c] =
       sum_{(n, k): nbh[b, n, k] = j} sum_p w[b, n, k, p] * dM[b, n, p*C + c]
  F  neighbor_max_backward:  dfeat[b, j, c] =
       sum_{(n, k): nbh[b, n, k] = j} [slot[b, n, c] == k] * dval[b, n, c]
where slot = k*, which kernel D writes when a backward will need it.  A
neighbourhood that repeats an id passes the max cotangent on once, to the
lowest k.  E and F read `inverse_neighbors`, a CSR inverse of nbh built
with integer sorts, and sum each output row in a fixed order: no atomics.

They replace the Pallas kernels of `dh3d_tpu/ops/pallas/banded_pallas.py`:
`_fwd_kernel` and `_moments_fwd_kernel` (C), `_max_kernel` (D),
`_moments_bwd_kernel`, `_bwd_kernel` and `_bwd_w1_kernel` (E),
`_bwd_slot_kernel` (F), and the out-of-band delivery of `_slot_kernel`
(all: indices here may be anything in [0, M)).  Features and weights are
f32, indices int64; N (rows of nbh) and M (rows of features) may differ.

CPU tensors take the plain versions, forward and backward, through the same
Functions; CUDA tensors launch the kernels.
"""

from __future__ import annotations

import torch

from dh3d_tpu_torch import kernels

MAX_P = 4
MAX_K = 64


def gather_neighbors(values: torch.Tensor, nbh: torch.Tensor) -> torch.Tensor:
    """values [B, M, C], nbh [B, N, K] int64 -> [B, N, K, C]."""
    b = torch.arange(values.shape[0], device=values.device)[:, None, None]
    return values[b, nbh]


def inverse_neighbors(nbh: torch.Tensor, M: int):
    """CSR inverse of a neighbourhood: nbh [B, N, K] int64 in [0, M) ->
    (rowptr [B, M + 1] int64, entries [B, N*K] int64).  The entries of key j
    are entries[b, rowptr[b, j]:rowptr[b, j + 1]], each the flat position
    n*K + k of an occurrence of j in nbh[b], ascending.  Integer
    bookkeeping only: a stable sort of the flat ids, and the first position
    of each key in the sorted ids."""
    B = nbh.shape[0]
    keys, entries = torch.sort(nbh.reshape(B, -1), dim=1, stable=True)
    bounds = torch.arange(M + 1, device=nbh.device).expand(B, M + 1)
    return torch.searchsorted(keys, bounds.contiguous()), entries


# ------------------------------ kernel C / E ------------------------------

def weighted_sum_plain(features, nbh, weights):
    """Plain PyTorch kernel C: a gather, then an einsum over k."""
    B, N, K, P = weights.shape
    f_k = gather_neighbors(features, nbh)
    return torch.einsum("bnkp,bnkc->bnpc", weights, f_k).reshape(B, N, -1)


def weighted_sum_backward_plain(dm, nbh, weights, M):
    """Plain PyTorch kernel E: each entry's cotangent row
    sum_p w[n, k, p] * dM[n, p, :], added into row nbh[n, k] (`index_add_`).
    dm [B, N, P*C], nbh [B, N, K], weights [B, N, K, P] -> [B, M, C]."""
    B, N, K, P = weights.shape
    C = dm.shape[-1] // P
    contrib = torch.einsum("bnkp,bnpc->bnkc", weights, dm.reshape(B, N, P, C))
    rows = nbh + M * torch.arange(B, device=nbh.device)[:, None, None]
    out = dm.new_zeros(B * M, C)
    out.index_add_(0, rows.reshape(-1), contrib.reshape(-1, C))
    return out.reshape(B, M, C)


def _weighted_sum_forward(features, nbh, weights):
    if not kernels.on_cuda(features, nbh, weights):
        return weighted_sum_plain(features, nbh, weights)
    B, M, C = features.shape
    N, K, P = weights.shape[1:]
    out = torch.empty(B, N, P * C, dtype=torch.float32,
                      device=features.device)
    kernels.WEIGHTED_SUM.launch(
        features.device, features.data_ptr(), nbh.data_ptr(),
        weights.data_ptr(), out.data_ptr(), B, N, M, C, K, P)
    return out


def weighted_sum_backward(dm: torch.Tensor, nbh: torch.Tensor,
                          weights: torch.Tensor, M: int) -> torch.Tensor:
    """The transpose of `weighted_sum` with respect to the features:
    dm [B, N, P*C] f32 (p-major, as kernel C writes it), nbh [B, N, K]
    int64 in [0, M), weights [B, N, K, P] f32, contiguous -> dfeat
    [B, M, C] f32.

    CPU tensors take the plain version; CUDA tensors build the CSR inverse
    of nbh and launch kernel E, which sums each key's entries in CSR order
    in f32."""
    B, N, K, P = weights.shape
    kernels.check(dm, "dm", torch.float32, (B, N, None))
    kernels.check(nbh, "nbh", torch.int64, (B, N, K))
    kernels.check(weights, "weights", torch.float32, (B, N, K, P))
    if dm.shape[-1] % P or not (1 <= P <= MAX_P and 1 <= K <= MAX_K):
        raise ValueError(f"weighted_sum_backward: dm width {dm.shape[-1]}, "
                         f"P={P} (<= {MAX_P}), K={K} (<= {MAX_K})")
    C = dm.shape[-1] // P
    if not kernels.on_cuda(dm, nbh, weights):
        return weighted_sum_backward_plain(dm, nbh, weights, M)
    rowptr, entries = inverse_neighbors(nbh, M)
    out = torch.empty(B, M, C, dtype=torch.float32, device=dm.device)
    kernels.WEIGHTED_SUM_BWD.launch(
        dm.device, dm.data_ptr(), weights.data_ptr(), rowptr.data_ptr(),
        entries.data_ptr(), out.data_ptr(), B, N, M, C, K, P)
    return out


class WeightedSum(torch.autograd.Function):
    """Kernel C forward, kernel E backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, features, nbh, weights):
        ctx.m = features.shape[1]
        ctx.save_for_backward(nbh, weights)
        return _weighted_sum_forward(features, nbh, weights)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        nbh, weights = ctx.saved_tensors
        return (weighted_sum_backward(dout.contiguous(), nbh, weights, ctx.m),
                None, None)


def weighted_sum(features: torch.Tensor, nbh: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """features [B, M, C] f32, nbh [B, N, K] int64 in [0, M),
    weights [B, N, K, P] f32 (P <= 4, K <= 64), all contiguous
    -> [B, N, P*C] f32, p-major.  Differentiable in `features`.

    CPU tensors take the plain version; CUDA tensors launch kernel C, which
    accumulates over k in ascending order in f32 (and kernel E in the
    backward)."""
    kernels.check(features, "features", torch.float32, (None, None, None))
    B = features.shape[0]
    kernels.check(nbh, "nbh", torch.int64, (B, None, None))
    N, K = nbh.shape[1:]
    kernels.check(weights, "weights", torch.float32, (B, N, K, None))
    P = weights.shape[-1]
    if not (1 <= P <= MAX_P and 1 <= K <= MAX_K):
        raise ValueError(f"weighted_sum: P={P} (<= {MAX_P}), K={K} (<= {MAX_K})")
    return WeightedSum.apply(features, nbh, weights)


# ------------------------------ kernel D / F ------------------------------

def neighbor_max_plain(features, nbh):
    """Plain PyTorch kernel D: a gather, then argmax over k (first
    occurrence) and the values, ids and slots it selects.  Returns
    (val [B, N, C], arg [B, N, C] int64, slot [B, N, C] int8)."""
    f_k = gather_neighbors(features, nbh)  # [B, N, K, C]
    arg_k = torch.argmax(f_k, dim=2, keepdim=True)  # [B, N, 1, C]
    val = torch.gather(f_k, 2, arg_k)[:, :, 0]
    ids = nbh[..., None].expand(-1, -1, -1, features.shape[-1])
    return (val, torch.gather(ids, 2, arg_k)[:, :, 0],
            arg_k[:, :, 0].to(torch.int8))


def neighbor_max_backward_plain(dval, nbh, slot, M):
    """Plain PyTorch kernel F: dval[n, c] goes to row nbh[n, slot[n, c]]
    (`scatter_add_`).  dval [B, N, C], nbh [B, N, K], slot [B, N, C]
    -> [B, M, C]."""
    ids = torch.gather(nbh, 2, slot.long())  # [B, N, C] global ids
    out = dval.new_zeros(dval.shape[0], M, dval.shape[-1])
    return out.scatter_add_(1, ids, dval)


def _check_neighbor_max(features, nbh):
    kernels.check(features, "features", torch.float32, (None, None, None))
    kernels.check(nbh, "nbh", torch.int64, (features.shape[0], None, None))
    K = nbh.shape[-1]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"neighbor_max: K={K} outside [1, {MAX_K}]")


def _neighbor_max_forward(features, nbh, with_slot):
    if not kernels.on_cuda(features, nbh):
        val, arg, slot = neighbor_max_plain(features, nbh)
        return val, arg, (slot if with_slot else None)
    B, M, C = features.shape
    N, K = nbh.shape[1:]
    val = torch.empty(B, N, C, dtype=torch.float32, device=features.device)
    arg = torch.empty(B, N, C, dtype=torch.int64, device=features.device)
    slot = (torch.empty(B, N, C, dtype=torch.int8, device=features.device)
            if with_slot else None)
    kernels.NEIGHBOR_MAX.launch(
        features.device, features.data_ptr(), nbh.data_ptr(),
        val.data_ptr(), arg.data_ptr(), slot.data_ptr() if with_slot else None,
        B, N, M, C, K)
    return val, arg, slot


def neighbor_max_with_slot(features: torch.Tensor, nbh: torch.Tensor):
    """Kernel D with its slot output, no autograd: features [B, M, C] f32,
    nbh [B, N, K] int64 (K <= 64) -> (val, arg int64, slot int8), each
    [B, N, C].  CPU tensors take the plain version."""
    _check_neighbor_max(features, nbh)
    return _neighbor_max_forward(features, nbh, True)


def neighbor_max_backward(dval: torch.Tensor, nbh: torch.Tensor,
                          slot: torch.Tensor, M: int) -> torch.Tensor:
    """The transpose of `neighbor_max`'s value with respect to the
    features: dval [B, N, C] f32, nbh [B, N, K] int64 in [0, M), slot
    [B, N, C] int8 (the winning k), contiguous -> dfeat [B, M, C] f32.

    CPU tensors take the plain version; CUDA tensors build the CSR inverse
    of nbh and launch kernel F."""
    B, N, K = nbh.shape
    kernels.check(dval, "dval", torch.float32, (B, N, None))
    kernels.check(nbh, "nbh", torch.int64, (B, N, K))
    C = dval.shape[-1]
    kernels.check(slot, "slot", torch.int8, (B, N, C))
    if not 1 <= K <= MAX_K:
        raise ValueError(f"neighbor_max_backward: K={K} outside [1, {MAX_K}]")
    if not kernels.on_cuda(dval, nbh, slot):
        return neighbor_max_backward_plain(dval, nbh, slot, M)
    rowptr, entries = inverse_neighbors(nbh, M)
    out = torch.empty(B, M, C, dtype=torch.float32, device=dval.device)
    kernels.NEIGHBOR_MAX_BWD.launch(
        dval.device, dval.data_ptr(), slot.data_ptr(), rowptr.data_ptr(),
        entries.data_ptr(), out.data_ptr(), B, N, M, C, K)
    return out


class NeighborMax(torch.autograd.Function):
    """Kernel D forward (with the slot when a backward will follow),
    kernel F backward (plain versions on the CPU).  `arg` is not
    differentiable."""

    @staticmethod
    def forward(ctx, features, nbh):
        need = ctx.needs_input_grad[0]
        val, arg, slot = _neighbor_max_forward(features, nbh, need)
        ctx.mark_non_differentiable(arg)
        ctx.m = features.shape[1]
        if need:
            ctx.save_for_backward(nbh, slot)
        return val, arg

    @staticmethod
    def backward(ctx, dval, _darg):
        if not ctx.needs_input_grad[0]:
            return None, None
        nbh, slot = ctx.saved_tensors
        return neighbor_max_backward(dval.contiguous(), nbh, slot, ctx.m), None


def neighbor_max(features: torch.Tensor, nbh: torch.Tensor):
    """features [B, M, C] f32, nbh [B, N, K] int64 in [0, M) (K <= 64),
    contiguous -> (val [B, N, C] f32, arg [B, N, C] int64 global ids).
    Ties keep the lowest k (`flex_pool_kernel.cc:44-49`).  `val` is
    differentiable in `features`.

    CPU tensors take the plain version; CUDA tensors launch kernel D (and
    kernel F in the backward)."""
    _check_neighbor_max(features, nbh)
    return NeighborMax.apply(features, nbh)
