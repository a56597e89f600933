"""Public wrappers of the port's kernels (port of `repro.kernels.ops`).

Dispatch follows the device of the tensors, never `torch.cuda.is_available()`:
CPU tensors go to the plain PyTorch versions in `kernels.ref`; CUDA tensors
launch the hand-written kernel or raise — there is no fallback from the
card to a plain version.  Each wrapper checks device, dtype, shape and
contiguity before it hands pointers to the kernel, and counts its launches
in `LAUNCHES`, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# kernel launches since the last reset_launches(), by kernel
LAUNCHES = {"pairwise_l2": 0, "l2_topk": 0, "ivf_scan": 0}

MAX_K = 128          # the top-k kernels keep four list slots per lane
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper
_TARGET_BLOCKS = 4 * 132  # a few waves over the H100's 132 SMs
IVF_MIN_RUN = 32     # an ivf_scan block selects k of at least this many x k


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on a mix or on any other device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel inputs on unsupported device {dev}")
    return dev.type == "cuda"


def _check(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_k(kernel: str, k: int) -> None:
    if k < 1:
        raise ValueError(f"{kernel}: k must be >= 1, got {k}")
    if k > MAX_K:
        raise NotImplementedError(
            f"{kernel}: k = {k} > {MAX_K} is not supported by the CUDA "
            f"kernel yet (ROADMAP B: the k > 128 extension)")


def _ieee_fp32() -> None:
    # distances stay IEEE float32 on the card: a TF32 product would change
    # which ids make a top k (this also covers the plain versions' matmul)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error "
                           f"{rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _merge_partials(pd: torch.Tensor, pi: torch.Tensor, k: int):
    """k best of per-block partials laid out in ascending index order: a
    stable sort keeps the lowest index first among equal distances."""
    vals, order = torch.sort(pd, dim=1, stable=True)
    return vals[:, :k], torch.gather(pi, 1, order[:, :k])


def pairwise_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D), (N, D) -> (Q, N) float32 squared L2 distances, clamped at 0.

    CUDA: float32 contiguous inputs, the `pairwise_l2` kernel."""
    if not _on_cuda(q, x):
        return ref.pairwise_l2_ref(q, x)
    _ieee_fp32()
    _check("pairwise_l2 q", q, torch.float32, 2)
    _check("pairwise_l2 x", x, torch.float32, 2)
    if q.shape[1] != x.shape[1]:
        raise ValueError(f"pairwise_l2: depth mismatch {tuple(q.shape)} vs "
                         f"{tuple(x.shape)}")
    nq, n = q.shape[0], x.shape[0]
    if nq > 65535 * 64:
        raise NotImplementedError(f"pairwise_l2: Q = {nq} exceeds the grid")
    out = torch.empty((nq, n), dtype=torch.float32, device=q.device)
    if nq and n:
        rc = _build.load("pairwise_l2").pairwise_l2(
            q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, n, q.shape[1],
            _stream())
        _raise_on(rc, "pairwise_l2")
        LAUNCHES["pairwise_l2"] += 1
    return out


def topk_l2(q: torch.Tensor, x: torch.Tensor, k: int, *, valid=None):
    """Fused distance + top-k: (dists (Q, k) ascending, ids (Q, k) int32).

    `valid` (N,) bool is the tombstone mask: masked rows never surface,
    and queries with fewer than k live rows underflow as +inf / -1.  On
    CUDA the (Q, N) distance matrix never reaches device memory; k <= 128
    (larger k raises NotImplementedError)."""
    if not _on_cuda(q, x, *([] if valid is None else [valid])):
        return ref.l2_topk_ref(q, x, k, valid)
    _ieee_fp32()
    _check_k("topk_l2", k)
    _check("topk_l2 q", q, torch.float32, 2)
    _check("topk_l2 x", x, torch.float32, 2)
    if valid is not None:
        _check("topk_l2 valid", valid, torch.bool, 1)
        if valid.shape[0] != x.shape[0]:
            raise ValueError("topk_l2: valid must have one entry per row")
    nq, n, d = q.shape[0], x.shape[0], q.shape[1]
    if x.shape[1] != d:
        raise ValueError(f"topk_l2: depth mismatch {tuple(q.shape)} vs "
                         f"{tuple(x.shape)}")
    if nq == 0 or n == 0:
        raise ValueError(f"topk_l2: empty input, Q = {nq}, N = {n}")
    lib = _build.load("l2_topk")
    qt = 1 if nq <= 16 else 2 if nq <= 32 else 4
    if lib.l2_topk_smem_bytes(qt, d, k) > SMEM_LIMIT:
        raise NotImplementedError(
            f"topk_l2: D = {d}, k = {k} need more shared memory than a block has")
    qtiles = -(-nq // (16 * qt))
    target = max(1, _TARGET_BLOCKS // max(qtiles, 1))
    chunk = max(64, -(-n // target))
    chunk = -(-chunk // 64) * 64
    nchunks = -(-n // chunk)
    if nchunks > 65535:
        raise NotImplementedError(f"topk_l2: N = {n} exceeds the grid")
    pd = torch.empty((nq, nchunks * k), dtype=torch.float32, device=q.device)
    pi = torch.empty(pd.shape, dtype=torch.int32, device=q.device)
    rc = lib.l2_topk_partial(
        q.data_ptr(), x.data_ptr(), None if valid is None else valid.data_ptr(),
        pd.data_ptr(), pi.data_ptr(), nq, n, d, k, chunk, nchunks, qt, _stream())
    _raise_on(rc, "l2_topk")
    LAUNCHES["l2_topk"] += 1
    vals, ids = _merge_partials(pd, pi, k)
    if valid is not None:
        ids = torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))
    return vals, ids


def _fold_tombstones(cand: torch.Tensor, valid: torch.Tensor, n: int):
    """Candidate ids whose row is tombstoned become -1 slots, so a removed
    object never surfaces from a stale list (one gather + where)."""
    safe = torch.clamp(cand, 0, n - 1).long()
    return torch.where((cand >= 0) & valid[safe], cand,
                       torch.full_like(cand, -1))


def ivf_scan_chunks(b: int, p: int, k: int) -> tuple[int, int]:
    """(run of P per block, blocks per query) of an `ivf_scan` launch.

    Enough blocks for a few waves over the SMs, but every run at least
    IVF_MIN_RUN * k slots long: each block writes its k best, so the kernel
    keeps about one slot in IVF_MIN_RUN and the merge sorts P / IVF_MIN_RUN
    partials a query, not P."""
    target = max(1, _TARGET_BLOCKS * 2 // max(b, 1))
    chunk = max(256, IVF_MIN_RUN * k, -(-p // target))
    return chunk, -(-p // chunk)


def ivf_scan_topk(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor, k: int,
                  *, valid=None):
    """Fused gather + L2 + top-k over per-query candidate ids.

    q (B, D), x (N, D), cand (B, P) int32 with -1 = invalid slot.  Returns
    (dists (B, k), ids (B, k) int32); underflowing slots (fewer than k
    valid candidates, including k > P) come back as +inf / -1.  `valid`
    (N,) bool folds tombstoned ids into -1 before the scan.  On CUDA,
    k <= 128 (larger k raises NotImplementedError)."""
    if valid is not None:
        cand = _fold_tombstones(cand, valid, x.shape[0])
    if not _on_cuda(q, x, cand):
        return ref.ivf_scan_ref(q, x, cand, k)
    _ieee_fp32()
    _check_k("ivf_scan_topk", k)
    _check("ivf_scan_topk q", q, torch.float32, 2)
    _check("ivf_scan_topk x", x, torch.float32, 2)
    _check("ivf_scan_topk cand", cand, torch.int32, 2)
    b, d = q.shape
    p = cand.shape[1]
    if x.shape[1] != d or cand.shape[0] != b:
        raise ValueError(f"ivf_scan_topk: shapes q {tuple(q.shape)}, "
                         f"x {tuple(x.shape)}, cand {tuple(cand.shape)}")
    if b == 0 or p == 0:
        raise ValueError(f"ivf_scan_topk: empty input, B = {b}, P = {p}")
    if b > 65535:
        raise NotImplementedError(f"ivf_scan_topk: B = {b} exceeds the grid")
    lib = _build.load("ivf_scan")
    if lib.ivf_scan_smem_bytes(d, k) > SMEM_LIMIT:
        raise NotImplementedError(
            f"ivf_scan_topk: D = {d}, k = {k} need more shared memory than "
            f"a block has")
    chunk, nchunks = ivf_scan_chunks(b, p, k)
    pd = torch.empty((b, nchunks * k), dtype=torch.float32, device=q.device)
    pp = torch.empty(pd.shape, dtype=torch.int32, device=q.device)
    rc = lib.ivf_scan_partial(
        q.data_ptr(), x.data_ptr(), cand.data_ptr(), pd.data_ptr(), pp.data_ptr(),
        b, x.shape[0], d, p, k, chunk, nchunks, _stream())
    _raise_on(rc, "ivf_scan")
    LAUNCHES["ivf_scan"] += 1
    vals, ppos = _merge_partials(pd, pp, k)
    ids = torch.gather(cand, 1, torch.clamp_min(ppos, 0).long())
    ids = torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))
    return vals, ids


# the index layer's names: the dispatch is by tensor device, so the
# reference's backend-dispatching `*_auto` wrappers are these same functions
topk_l2_auto = topk_l2
ivf_scan_auto = ivf_scan_topk
