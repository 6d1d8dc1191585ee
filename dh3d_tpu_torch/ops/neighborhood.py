"""Neighbourhood reductions and their transposes: kernels C, D, E and F
(`csrc/neighborhood.cu`) and their plain versions.

  weighted_sum:  out[b, n, p*C + c] = sum_k w[b, n, k, p] * f[b, nbh[b, n, k], c]
  flex_moments:  the same with w = `flex_weights(pos, nbh)` = [1, pos[nbh[.,
                 k]] - pos[nbh[., 0]]], built inside the kernel: no weight
                 tensor exists, and the output has `weighted_sum`'s bits
  neighbor_max:  val[b, n, c] = max_k f[b, nbh[b, n, k], c],
                 arg[b, n, c] = nbh[b, n, k*], k* the lowest k attaining it
                 (a NaN wins over any number, the first NaN over the others)

All three are `torch.autograd.Function`s (`WeightedSum`, `FlexMoments`,
`NeighborMax`).  The features get a gradient; the weights, the positions
and the indices get none, as in the JAX VJPs (`banded_pallas.py:25-29`),
which give the weights a zero cotangent and the positions none.  Their
backwards are kernels too:
  E  weighted_sum_backward:  dfeat[b, j, c] =
       sum_{(n, k): nbh[b, n, k] = j} sum_p w[b, n, k, p] * dM[b, n, p*C + c]
  F  neighbor_max_backward:  dfeat[b, j, c] =
       sum_{(n, k): nbh[b, n, k] = j} [slot[b, n, c] == k] * dval[b, n, c]
where slot = k*, which kernel D writes when a backward will need it.  A
neighbourhood that repeats an id passes the max cotangent on once, to the
lowest k.  E and F read `inverse_neighbors`, a CSR inverse of nbh built
with integer sorts, and sum each output row in a fixed order: no atomics.

A neighbourhood serves several ops (a level's two flex convs and its
pool), so its inverse is built once and shared: the model makes one
`NeighborInverse` next to each neighbourhood and passes it as `inverse=`
to every op over it; the Functions keep it on ctx, and its first `get()`
in a backward builds the inverse for all of them.  An op given none makes
its own holder, which only its backward reads.

Kernels C and D take a launch plan, `row_plan(C, K)` = (VEC channels a
thread, lanes a row, passes over the channels); `plan=` forces one, and the
C entry points refuse a plan that does not fit C or the tensors' alignment.

They replace the Pallas kernels of `dh3d_tpu/ops/pallas/banded_pallas.py`:
`_fwd_kernel` and `_moments_fwd_kernel` (C), `_max_kernel` (D),
`_moments_bwd_kernel`, `_bwd_kernel` and `_bwd_w1_kernel` (E),
`_bwd_slot_kernel` (F), and the out-of-band delivery of `_slot_kernel`
(all: indices here may be anything in [0, M)).  Features and weights are
f32, indices int64; N (rows of nbh) and M (rows of features) may differ.

`flex_moments` also takes bf16 features, the model's bf16 compute_dtype:
the function `_flex_moments` of `dh3d_tpu/ops/flex.py` computes on bf16
features on the CPU, with its rounding points: delta = pos[nk] - pos[n0]
in f32, rounded to bf16; the p = 0 moment (`jnp.sum` of bf16: an f32 sum
rounded once) rounded to bf16; the other moments f32 sums of exact
bf16 x bf16 products; the output f32.  Its backward rounds the p = 0 slice
of the cotangent to bf16 (the cast of m0), sums in f32 and rounds the
feature gradient to bf16 once (the JAX gather path rounds it at every add
of its scatter).  On the card these are the bf16 cases of kernels C and E
(`FLEX_MOMENTS_BF16`, `FLEX_MOMENTS_BWD_BF16`, counted apart from the f32
cases); any other feature dtype is refused.

CPU tensors take the plain versions, forward and backward, through the same
Functions; CUDA tensors launch the kernels.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from dh3d_tpu_torch import kernels, trace

MAX_P = 4
MAX_K = 64
ENTRY_SHIFT = 6  # an inverse's entry is (n << 6) | k: exact for k < MAX_K
MAX_ROWS = (1 << 25) - 1  # and int32 for n < 2^25
UNROLLED_K = (3, 8)  # the K kernels C and D unroll (given >= K lanes a row)
ROW_GATHERS = 64  # gathers a row group of kernels C and D aims at a pass


def gather_neighbors(values: torch.Tensor, nbh: torch.Tensor) -> torch.Tensor:
    """values [B, M, C], nbh [B, N, K] int64 -> [B, N, K, C]."""
    b = torch.arange(values.shape[0], device=values.device)[:, None, None]
    return values[b, nbh]


def inverse_neighbors(nbh: torch.Tensor, M: int):
    """CSR inverse of a neighbourhood, in the layout kernels E and F read:
    nbh [B, N, K] int64 in [0, M) -> (rowptr [B, M + 1] int32, entries
    [B, N*K] int32).  The entries of key j are entries[b, rowptr[b, j]:
    rowptr[b, j + 1]], one for each occurrence nbh[b, n, k] = j, packed as
    (n << ENTRY_SHIFT) | k and ascending (the order of n*K + k).

    Integer bookkeeping in PyTorch ops, on nbh's device: one stable sort of
    the flat keys b*M + j, and a binary search for the first entry of each
    key.  Exact, so the same on every run."""
    B, N, K = nbh.shape
    if not (1 <= K <= MAX_K and N <= MAX_ROWS and B * max(M + 1, N * K)
            < 2**31):
        raise ValueError(f"inverse_neighbors: nbh {tuple(nbh.shape)}, M={M}:"
                         f" needs K <= {MAX_K}, N <= {MAX_ROWS} and int32 "
                         "offsets")
    dev = nbh.device
    batch = torch.arange(B, device=dev, dtype=torch.int32)[:, None]
    keys = nbh.reshape(B, N * K).to(torch.int32) + M * batch
    keys, order = torch.sort(keys.reshape(-1), stable=True)
    # n*K + k within the cloud; int32 throughout
    flat = order.view(B, N * K).to(torch.int32) - (N * K) * batch
    entries = (flat // K) << ENTRY_SHIFT | flat % K
    bounds = M * batch + torch.arange(M + 1, device=dev, dtype=torch.int32)
    rowptr = torch.searchsorted(keys, bounds.reshape(-1), out_int32=True)
    return rowptr.view(B, M + 1) - (N * K) * batch, entries


def unpack_entries(entries):
    """(n, k) of an inverse's entries, (n << ENTRY_SHIFT) | k (a tensor or
    a numpy array)."""
    return entries >> ENTRY_SHIFT, entries & ((1 << ENTRY_SHIFT) - 1)


class NeighborInverse:
    """The CSR inverse of one neighbourhood, built on the first `get()` and
    kept for the next: make one next to a neighbourhood and pass it as
    `inverse=` to every op over it, and the backwards over that
    neighbourhood build its inverse once between them.  It holds `nbh`
    (by reference: the ops check that they were given this very tensor)
    and `m`, the key count; it lives as long as its last holder, which in
    training is the autograd graph (the Functions keep it on ctx)."""

    def __init__(self, nbh: torch.Tensor, m: int):
        self.nbh, self.m = nbh, m
        self._csr = None
        made = getattr(_local, "made", None)
        if made is not None:
            made.append(self)

    @property
    def built(self) -> bool:
        return self._csr is not None

    def get(self):
        """(rowptr, entries) of `inverse_neighbors(nbh, m)`, built once
        (span `csr_inverse`)."""
        if self._csr is None:
            with trace.span("csr_inverse", self.nbh):
                self._csr = inverse_neighbors(self.nbh, self.m)
        return self._csr


_local = threading.local()  # .made: the list `collect_inverses` fills


@contextlib.contextmanager
def collect_inverses():
    """Yields a list of the `NeighborInverse` holders this thread makes
    while entered, in the order it makes them (a train step's CUDA graphs
    build the ones its eager backward builds, in a stretch of their
    own)."""
    prev, _local.made = getattr(_local, "made", None), []
    try:
        yield _local.made
    finally:
        _local.made = prev


def _check_inverse(inverse, nbh: torch.Tensor, M: int, name: str) -> None:
    if inverse is not None and (inverse.nbh is not nbh or inverse.m != M):
        raise ValueError(f"{name}: `inverse` was made for another "
                         f"neighbourhood (m={inverse.m}; here M={M})")


# ------------------------------ launch plans ------------------------------

def row_plan(C: int, K: int, vec_max: int = 4) -> tuple[int, int, int]:
    """The launch plan of kernels C and D for C channels and K neighbours:
    (vec, lanes, passes).  A row group of `lanes` threads (a power of two,
    at most 32) owns a query row; a thread owns `vec` adjacent channels
    (4, 2 or 1: the largest that divides C and is at most `vec_max`, which
    the wrappers lower to what the tensors' alignment allows), channel
    (pass * lanes + lane) * vec onward in each of `passes` passes.

    A row's ids and weights are loaded and shuffled once for all its
    passes, so few lanes with several passes beat a lane a vector: about
    `ROW_GATHERS` gathers a group and pass (lanes * K), at least 8 lanes
    (measured on an H100: 8 lanes at K = 8, 16 at K = 3), fewer when C has
    fewer vectors.  For the K the kernels unroll (`UNROLLED_K`) a group
    needs K lanes to load the K ids in one go, so vec is halved while C
    gives too few."""
    if C < 1 or not 1 <= K <= MAX_K or vec_max not in (1, 2, 4):
        raise ValueError(f"row_plan: C={C}, K={K} (<= {MAX_K}), "
                         f"vec_max={vec_max}")
    vec = next(v for v in (4, 2, 1) if v <= vec_max and C % v == 0)
    while vec > 1 and K in UNROLLED_K and _lanes(C // vec) < K:
        vec //= 2
    lanes = min(_lanes(C // vec), max(8, _lanes(ROW_GATHERS // _lanes(K))))
    return vec, lanes, -(-C // (vec * lanes))


def _lanes(vectors: int) -> int:
    """The power of two that holds `vectors`, at most 32."""
    return min(32, 1 << (vectors - 1).bit_length())


def _plan(plan, C, K, features):
    """`plan`, or `row_plan` with the vector width the base of `features`
    allows (the kernels' other vector accesses are to fresh outputs)."""
    if plan is not None:
        return tuple(plan)
    size = features.element_size()
    vec_max = next(v for v in (4, 2, 1)
                   if features.data_ptr() % (size * v) == 0)
    return row_plan(C, K, vec_max)


# ------------------------------ kernel C / E ------------------------------

def flex_weights(positions: torch.Tensor, nbh: torch.Tensor) -> torch.Tensor:
    """[B, N, K, 1 + Dp] weights [1, pos[nk] - pos[n0]] of the moments."""
    p_k = gather_neighbors(positions, nbh)  # [B, N, K, Dp]
    delta = p_k - p_k[:, :, :1]
    return torch.cat([torch.ones_like(delta[..., :1]), delta], dim=-1)


def weighted_sum_plain(features, nbh, weights):
    """Plain PyTorch kernel C: a gather, then an einsum over k."""
    B, N, K, P = weights.shape
    f_k = gather_neighbors(features, nbh)
    return torch.einsum("bnkp,bnkc->bnpc", weights, f_k).reshape(B, N, -1)


FEATURE_DTYPES = (torch.float32, torch.bfloat16)  # of flex_moments


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to the nearest bf16 (ties to even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _bf16_weights(positions, nbh):
    """`flex_weights` with the deltas rounded to bf16: the weights of the
    moments of bf16 features."""
    w = flex_weights(positions, nbh)
    return torch.cat([w[..., :1], round_bf16(w[..., 1:])], dim=-1)


def flex_moments_plain(features, positions, nbh):
    """Plain PyTorch `flex_moments`: kernel C's plain version on the
    weights `flex_weights` builds.  bf16 features: the bf16 rounding points
    (the module docstring), f32 output."""
    if features.dtype != torch.bfloat16:
        return weighted_sum_plain(features, nbh, flex_weights(positions, nbh))
    B, N, K = nbh.shape
    C = features.shape[-1]
    m = weighted_sum_plain(features.float(), nbh,
                           _bf16_weights(positions, nbh)).view(B, N, -1, C)
    return torch.cat([round_bf16(m[:, :, :1]), m[:, :, 1:]],
                     dim=2).view(B, N, -1)


def flex_moments_backward_plain(dm, positions, nbh, M,
                                dtype=torch.float32):
    """Plain PyTorch `flex_moments_backward`: kernel E's plain version on
    the weights `flex_weights` builds.  dtype bf16 (the features'): the p = 0
    slice of dm and the deltas rounded to bf16, the sum in f32 rounded once
    to bf16."""
    if dtype != torch.bfloat16:
        return weighted_sum_backward_plain(
            dm, nbh, flex_weights(positions, nbh), M)
    B, N, _ = dm.shape
    d = dm.view(B, N, 1 + positions.shape[-1], -1)
    d = torch.cat([round_bf16(d[:, :, :1]), d[:, :, 1:]], dim=2)
    return weighted_sum_backward_plain(
        d.view(B, N, -1), nbh, _bf16_weights(positions, nbh),
        M).to(torch.bfloat16)


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


def _weighted_sum_forward(features, nbh, weights, plan=None):
    if not kernels.on_cuda(features, nbh, weights):
        return weighted_sum_plain(features, nbh, weights)
    return _launch_c(kernels.WEIGHTED_SUM, features, nbh, weights,
                     weights.shape[-1], plan)


def _flex_moments_forward(features, positions, nbh, plan=None):
    if not kernels.on_cuda(features, positions, nbh):
        return flex_moments_plain(features, positions, nbh)
    kernel = (kernels.FLEX_MOMENTS_BF16 if features.dtype == torch.bfloat16
              else kernels.FLEX_MOMENTS)
    return _launch_c(kernel, features, nbh, positions,
                     1 + positions.shape[-1], plan)


def _launch_c(kernel, features, nbh, w, P, plan):
    """Kernel C on CUDA tensors; `w` is the weights or the positions."""
    B, M, C = features.shape
    N, K = nbh.shape[1:]
    out = torch.empty(B, N, P * C, dtype=torch.float32,
                      device=features.device)
    kernel.launch(
        features.device, features.data_ptr(), nbh.data_ptr(), w.data_ptr(),
        out.data_ptr(), B, N, M, C, K, P, *_plan(plan, C, K, features))
    return out


def weighted_sum_backward(dm: torch.Tensor, nbh: torch.Tensor,
                          weights: torch.Tensor, M: int,
                          inverse: NeighborInverse | None = None
                          ) -> torch.Tensor:
    """The transpose of `weighted_sum` with respect to the features:
    dm [B, N, P*C] f32 (p-major, as kernel C writes it), nbh [B, N, K]
    int64 in [0, M), weights [B, N, K, P] f32, contiguous -> dfeat
    [B, M, C] f32.  `inverse`, a `NeighborInverse(nbh, M)`, shares the
    CSR inverse with the other ops over nbh; without it one is built here.

    CPU tensors take the plain version; CUDA tensors launch kernel E on the
    CSR inverse of nbh, which sums each key's entries in CSR order in
    f32."""
    B, N, K, P = weights.shape
    kernels.check(dm, "dm", torch.float32, (B, N, None))
    kernels.check(nbh, "nbh", torch.int64, (B, N, K))
    kernels.check(weights, "weights", torch.float32, (B, N, K, P))
    if dm.shape[-1] % P or not (1 <= P <= MAX_P and 1 <= K <= MAX_K):
        raise ValueError(f"weighted_sum_backward: dm width {dm.shape[-1]}, "
                         f"P={P} (<= {MAX_P}), K={K} (<= {MAX_K})")
    _check_inverse(inverse, nbh, M, "weighted_sum_backward")
    return _weighted_sum_backward(dm, nbh, weights,
                                  inverse or NeighborInverse(nbh, M))


def _weighted_sum_backward(dm, nbh, weights, inverse):
    M = inverse.m
    if not kernels.on_cuda(dm, nbh, weights):
        return weighted_sum_backward_plain(dm, nbh, weights, M)
    B, N, K, P = weights.shape
    C = dm.shape[-1] // P
    rowptr, entries = inverse.get()
    out = torch.empty(B, M, C, dtype=torch.float32, device=dm.device)
    kernels.WEIGHTED_SUM_BWD.launch(
        dm.device, dm.data_ptr(), weights.data_ptr(), rowptr.data_ptr(),
        entries.data_ptr(), out.data_ptr(), B, N, M, C, K, P)
    return out


class WeightedSum(torch.autograd.Function):
    """Kernel C forward, kernel E backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, features, nbh, weights, inverse=None, plan=None):
        ctx.inverse = inverse or NeighborInverse(nbh, features.shape[1])
        ctx.save_for_backward(nbh, weights)
        return _weighted_sum_forward(features, nbh, weights, plan)

    @staticmethod
    def backward(ctx, dout):
        # the forward checked the inputs and that `inverse` is nbh's (the
        # unpacked nbh may be another tensor object: saved-tensor hooks)
        if not ctx.needs_input_grad[0]:
            return (None,) * 5
        nbh, weights = ctx.saved_tensors
        return (_weighted_sum_backward(dout.contiguous(), nbh, weights,
                                       ctx.inverse),
                None, None, None, None)


def weighted_sum(features: torch.Tensor, nbh: torch.Tensor,
                 weights: torch.Tensor,
                 inverse: NeighborInverse | None = None,
                 plan: tuple[int, int, int] | None = None) -> torch.Tensor:
    """features [B, M, C] f32, nbh [B, N, K] int64 in [0, M),
    weights [B, N, K, P] f32 (P <= 4, K <= 64), all contiguous
    -> [B, N, P*C] f32, p-major.  Differentiable in `features`; `inverse`
    (a `NeighborInverse(nbh, M)`) is what the backward reads.

    CPU tensors take the plain version; CUDA tensors launch kernel C, which
    accumulates over k in ascending order in f32 (and kernel E in the
    backward): the same bits whatever `plan` (default `row_plan`) is."""
    kernels.check(features, "features", torch.float32, (None, None, None))
    B = features.shape[0]
    kernels.check(nbh, "nbh", torch.int64, (B, None, None))
    N, K = nbh.shape[1:]
    kernels.check(weights, "weights", torch.float32, (B, N, K, None))
    P = weights.shape[-1]
    if not (1 <= P <= MAX_P and 1 <= K <= MAX_K):
        raise ValueError(f"weighted_sum: P={P} (<= {MAX_P}), K={K} (<= {MAX_K})")
    _check_inverse(inverse, nbh, features.shape[1], "weighted_sum")
    return WeightedSum.apply(features, nbh, weights, inverse, plan)


def flex_moments_backward(dm: torch.Tensor, positions: torch.Tensor,
                          nbh: torch.Tensor,
                          inverse: NeighborInverse | None = None,
                          dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The transpose of `flex_moments` with respect to the features:
    dm [B, N, (1 + Dp)*C] f32, positions [B, M, Dp] f32, nbh [B, N, K]
    int64 in [0, M), contiguous -> dfeat [B, M, C] of `dtype`, the
    features' dtype.  f32: the bits of `weighted_sum_backward` on
    `flex_weights(positions, nbh)`.  bf16: the transpose of the bf16
    moments (the module docstring), rounded to bf16 once.

    CPU tensors take the plain version; CUDA tensors launch kernel E (its
    bf16 case for bf16), which builds each entry's weights from the
    positions."""
    if dtype not in FEATURE_DTYPES:
        raise ValueError(f"flex_moments_backward: dtype {dtype}, expected "
                         "float32 or bfloat16")
    B, N, K = nbh.shape
    kernels.check(nbh, "nbh", torch.int64, (B, N, K))
    kernels.check(positions, "positions", torch.float32, (B, None, None))
    kernels.check(dm, "dm", torch.float32, (B, N, None))
    M, P = positions.shape[1], 1 + positions.shape[2]
    if dm.shape[-1] % P or not (2 <= P <= MAX_P and 1 <= K <= MAX_K):
        raise ValueError(f"flex_moments_backward: dm width {dm.shape[-1]}, "
                         f"P={P} (2..{MAX_P}), K={K} (<= {MAX_K})")
    _check_inverse(inverse, nbh, M, "flex_moments_backward")
    return _flex_moments_backward(dm, positions, nbh,
                                  inverse or NeighborInverse(nbh, M), dtype)


def _flex_moments_backward(dm, positions, nbh, inverse, dtype=torch.float32):
    M = inverse.m
    if not kernels.on_cuda(dm, positions, nbh):
        return flex_moments_backward_plain(dm, positions, nbh, M, dtype)
    B, N, K = nbh.shape
    P = 1 + positions.shape[-1]
    C = dm.shape[-1] // P
    rowptr, entries = inverse.get()
    out = torch.empty(B, M, C, dtype=dtype, device=dm.device)
    kernel = (kernels.FLEX_MOMENTS_BWD_BF16 if dtype == torch.bfloat16
              else kernels.FLEX_MOMENTS_BWD)
    kernel.launch(
        dm.device, dm.data_ptr(), positions.data_ptr(), nbh.data_ptr(),
        rowptr.data_ptr(), entries.data_ptr(), out.data_ptr(), B, N, M, C,
        K, P)
    return out


class FlexMoments(torch.autograd.Function):
    """Kernel C on positions forward, kernel E on positions backward (plain
    versions on the CPU); the feature gradient in the features' dtype."""

    @staticmethod
    def forward(ctx, features, positions, nbh, inverse=None, plan=None):
        ctx.inverse = inverse or NeighborInverse(nbh, features.shape[1])
        ctx.dtype = features.dtype
        ctx.save_for_backward(nbh, positions)
        return _flex_moments_forward(features, positions, nbh, plan)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:  # checked in the forward, as above
            return (None,) * 5
        nbh, positions = ctx.saved_tensors
        return (_flex_moments_backward(dout.contiguous(), positions, nbh,
                                       ctx.inverse, ctx.dtype),
                None, None, None, None)


def flex_moments(features: torch.Tensor, positions: torch.Tensor,
                 nbh: torch.Tensor, inverse: NeighborInverse | None = None,
                 plan: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The flex-conv moments: features [B, M, C] f32 or bf16, positions
    [B, M, Dp] f32 (1 <= Dp <= 3), nbh [B, N, K] int64 in [0, M) with the
    centre at k = 0 (K <= 64), all contiguous -> [B, N, (1 + Dp)*C] f32,
    p-major.  f32: `weighted_sum(features, nbh, flex_weights(positions,
    nbh))` bit for bit, without the weight tensor.  bf16: the moments of the
    JAX function on bf16 features (the module docstring); the gradient is
    bf16.  Any other dtype raises ValueError.  Differentiable in
    `features`; `inverse` and `plan` as in `weighted_sum`.

    CPU tensors take the plain version; CUDA tensors launch kernel C (its
    bf16 case for bf16), which builds the weights from the positions (and
    kernel E in the backward)."""
    if features.dtype not in FEATURE_DTYPES:
        raise ValueError(f"flex_moments: features dtype {features.dtype}, "
                         "expected float32 or bfloat16")
    kernels.check(features, "features", features.dtype, (None, None, None))
    B, M = features.shape[:2]
    kernels.check(positions, "positions", torch.float32, (B, M, None))
    kernels.check(nbh, "nbh", torch.int64, (B, None, None))
    P, K = 1 + positions.shape[-1], nbh.shape[-1]
    if not (2 <= P <= MAX_P and 1 <= K <= MAX_K):
        raise ValueError(f"flex_moments: P={P} (2..{MAX_P}), K={K} "
                         f"(<= {MAX_K})")
    _check_inverse(inverse, nbh, M, "flex_moments")
    return FlexMoments.apply(features, positions, nbh, inverse, plan)


# ------------------------------ kernel D / F ------------------------------

def neighbor_max_plain(features, nbh):
    """Plain PyTorch kernel D: a gather, then argmax over k (first
    occurrence; a NaN counts as the greatest value, so the first NaN) and
    the values, ids and slots it selects.  Returns
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


def _neighbor_max_forward(features, nbh, with_slot, with_arg=True,
                          plan=None):
    """(val, arg or None, slot or None): kernel D writes only the outputs
    asked for."""
    if not kernels.on_cuda(features, nbh):
        val, arg, slot = neighbor_max_plain(features, nbh)
        return (val, arg if with_arg else None, slot if with_slot else None)
    B, M, C = features.shape
    N, K = nbh.shape[1:]
    dev = features.device
    val = torch.empty(B, N, C, dtype=torch.float32, device=dev)
    arg = (torch.empty(B, N, C, dtype=torch.int64, device=dev)
           if with_arg else None)
    slot = (torch.empty(B, N, C, dtype=torch.int8, device=dev)
            if with_slot else None)
    kernels.NEIGHBOR_MAX.launch(
        dev, features.data_ptr(), nbh.data_ptr(), val.data_ptr(),
        arg.data_ptr() if with_arg else None,
        slot.data_ptr() if with_slot else None, B, N, M, C, K,
        *_plan(plan, C, K, features))
    return val, arg, slot


def neighbor_max_with_slot(features: torch.Tensor, nbh: torch.Tensor,
                           with_arg: bool = True,
                           plan: tuple[int, int, int] | None = None):
    """Kernel D with its slot output, no autograd: features [B, M, C] f32,
    nbh [B, N, K] int64 (K <= 64) -> (val, arg int64 or None when
    `with_arg` is False, slot int8), each [B, N, C].  CPU tensors take the
    plain version."""
    _check_neighbor_max(features, nbh)
    return _neighbor_max_forward(features, nbh, True, with_arg, plan)


def neighbor_max_backward(dval: torch.Tensor, nbh: torch.Tensor,
                          slot: torch.Tensor, M: int,
                          inverse: NeighborInverse | None = None
                          ) -> torch.Tensor:
    """The transpose of `neighbor_max`'s value with respect to the
    features: dval [B, N, C] f32, nbh [B, N, K] int64 in [0, M), slot
    [B, N, C] int8 (the winning k), contiguous -> dfeat [B, M, C] f32.
    `inverse` as in `weighted_sum_backward`.

    CPU tensors take the plain version; CUDA tensors launch kernel F on the
    CSR inverse of nbh."""
    B, N, K = nbh.shape
    kernels.check(dval, "dval", torch.float32, (B, N, None))
    kernels.check(nbh, "nbh", torch.int64, (B, N, K))
    C = dval.shape[-1]
    kernels.check(slot, "slot", torch.int8, (B, N, C))
    if not 1 <= K <= MAX_K:
        raise ValueError(f"neighbor_max_backward: K={K} outside [1, {MAX_K}]")
    _check_inverse(inverse, nbh, M, "neighbor_max_backward")
    return _neighbor_max_backward(dval, nbh, slot,
                                  inverse or NeighborInverse(nbh, M))


def _neighbor_max_backward(dval, nbh, slot, inverse):
    M = inverse.m
    if not kernels.on_cuda(dval, nbh, slot):
        return neighbor_max_backward_plain(dval, nbh, slot, M)
    B, N, K = nbh.shape
    C = dval.shape[-1]
    rowptr, entries = inverse.get()
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
    def forward(ctx, features, nbh, inverse=None, with_arg=True, plan=None):
        need = ctx.needs_input_grad[0]
        val, arg, slot = _neighbor_max_forward(features, nbh, need, with_arg,
                                               plan)
        if with_arg:
            ctx.mark_non_differentiable(arg)
        ctx.inverse = inverse or NeighborInverse(nbh, features.shape[1])
        if need:
            ctx.save_for_backward(nbh, slot)
        return val, arg

    @staticmethod
    def backward(ctx, dval, _darg):
        if not ctx.needs_input_grad[0]:
            return (None,) * 5
        nbh, slot = ctx.saved_tensors  # checked in the forward, as above
        return (_neighbor_max_backward(dval.contiguous(), nbh, slot,
                                       ctx.inverse),
                None, None, None, None)


def neighbor_max(features: torch.Tensor, nbh: torch.Tensor,
                 inverse: NeighborInverse | None = None,
                 with_arg: bool = True,
                 plan: tuple[int, int, int] | None = None):
    """features [B, M, C] f32, nbh [B, N, K] int64 in [0, M) (K <= 64),
    contiguous -> (val [B, N, C] f32, arg [B, N, C] int64 global ids, or
    None when `with_arg` is False: the ids are then not computed).

    The winner of a neighbourhood is `torch.argmax`'s and `jnp.argmax`'s:
    a candidate replaces the best so far when it is greater (strict: ties
    keep the lowest k, `flex_pool_kernel.cc:44-49`) or when it is NaN and
    the best so far is not.  So a NaN among the neighbours gives val NaN
    and the id of the first NaN in k order, and the backward sends the
    cotangent to that row; +inf and -inf are ordinary values.

    `val` is differentiable in `features`; `inverse` (a
    `NeighborInverse(nbh, M)`) is what the backward reads; `plan` forces a
    launch plan (default `row_plan`).

    CPU tensors take the plain version; CUDA tensors launch kernel D (and
    kernel F in the backward)."""
    _check_neighbor_max(features, nbh)
    _check_inverse(inverse, nbh, features.shape[1], "neighbor_max")
    return NeighborMax.apply(features, nbh, inverse, with_arg, plan)
