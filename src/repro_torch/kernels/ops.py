"""Public wrappers of the port's kernels (port of `repro.kernels.ops`).

Dispatch follows the device of the tensors, never `torch.cuda.is_available()`:
CPU tensors go to the plain PyTorch versions in `kernels.ref`; CUDA tensors
launch the hand-written kernel or raise — there is no fallback from the
card to a plain version.  Each wrapper checks device, dtype, shape and
contiguity before it hands pointers to the kernel, and counts its launches
in `LAUNCHES`, so a run can show that its path went through the kernels.

Meta tensors (the dry-run's, `repro_torch.launch.dryrun`) take the CUDA
path's checks and its work around the launch, and in place of the launch
get empty outputs of the kernel's shapes and dtypes: nothing is built or
launched, and `LAUNCHES` does not move.  A launch and a meta call alike
add the kernel's work (`kernels.cost`) to the open cost records.
"""

from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import _build, cost, ref

# kernel launches since the last reset_launches(), by kernel; flash_attention
# has two: "flash_attention" (float32 FMA products: float32 inputs, and bf16
# at the small check widths) and "flash_attention_wgmma" (bf16 on the
# tensor cores at FLASH_WGMMA_HEAD_DIMS);
# the IVF probe's list-major scan counts as "ivf_scan_lists", apart from the
# per-query "ivf_scan"; the IVF-PQ shortlist's list-major scan as
# "pq_adc_lists", apart from the per-query "pq_adc"; pairwise_l2_batched
# counts as "pairwise_l2"
LAUNCHES = {"pairwise_l2": 0, "l2_topk": 0, "ivf_scan": 0, "ivf_scan_lists": 0,
            "pq_adc": 0, "pq_adc_lists": 0, "flash_attention": 0,
            "flash_attention_wgmma": 0}
# the same launches by (kernel, shape): pairwise_l2 (Q, N, D) or batched
# (Q, N, D, M); l2_topk (Q, N, D, k); ivf_scan (B, P, D, k); ivf_scan_lists
# (B, nprobe, cap, D, k); pq_adc (B, P, M, C); pq_adc_lists (B, nprobe, cap,
# M, kk); the flash kernels (B, S, T, H, KV, Dk, Dv, mask kind): see the *_key
# helpers
SHAPE_LAUNCHES: Counter = Counter()

# the top-k kernels' longest list (topk_common.cuh's TOPK_MAX_K): every k
# the reference's benchmarks ask for (fig4's k' 160, 400 at --full); l2_topk
# keeps lists up to 128 in registers, longer ones in shared memory
MAX_K = 1024
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper
_TARGET_BLOCKS = 4 * 132  # a few waves over the H100's 132 SMs
# l2_topk: one wave of blocks (a 64-query block fills an SM's shared
# memory; two 16-query blocks fit one), so each block's run is as long as
# it can be: a block builds its k-lists anew, about k (1 + ln(run / k))
# inserts a query
_TOPK_TARGET_BLOCKS = 132
# catalog rows whose k-th distance bounds each query's k-th from above
# (`topk_l2_bound`), from catalogs of TOPK_SAMPLE_MIN_N rows on: on
# smaller ones the sample is too large a share of the catalog to pay
TOPK_SAMPLE, TOPK_SAMPLE_MIN_N = 16384, 131072
# ivf_scan: slots a block scores before it selects (csrc/ivf_scan.cu's
# PASS), the shortest run a block takes (its 8 warps' 8 slots in flight),
# and the most blocks a query's cluster holds (non-portable above 8)
IVF_PASS, IVF_MIN_RUN, IVF_MAX_CLUSTER = 1024, 64, 16
# ivf_scan_lists: rows of up to 256 floats (32-row tiles in a 2-stage ring
# and 8 queries in shared memory); lists cut into runs of at least
# _LISTS_MIN_RUN * k slots for about _LISTS_TARGET_BLOCKS blocks
IVF_LISTS_MAX_D, _LISTS_MIN_RUN, _LISTS_TARGET_BLOCKS = 256, 8, 8 * 132
_MERGE_MAX_WIDTH = 4096  # partials a query the merge sorts in one block
_SMS = 132           # the H100's SMs
# pairwise_l2's skinny design (pairwise_l2.cu): up to 16 queries, 8 warps of
# 32-row tiles in 2-stage rings of 64 columns (rows padded to 68 floats)
SKINNY_MAX_Q = 16
_SK_WARPS, _SK_ROWS, _SK_DK, _SK_STAGES, _SK_LD = 8, 32, 64, 2, 68
PAIRWISE_KINDS = {"tile64": 0, "tile32": 1, "skinny": 2}
PQ_MAX_C = 256       # pq_adc codes are uint8
# (Dk, Dv) head widths of q / k and of v the flash kernels are built for:
# the dense LMs' D 64 / 128, hubert-xlarge's 80, deepseek-v3's MLA prefill
# (nope 128 + rope 64, v 128) and its SMOKE widths (16 + 8, 16), and the
# small widths of the kernel checks
FLASH_HEAD_DIMS = ((16, 16), (24, 16), (32, 32), (64, 64), (80, 80), (128, 128),
                   (192, 128))
# of which bf16 takes flash_attention_wgmma (rows as 64-column TMA boxes;
# hubert's 80 as two, the second zero past column 80)
FLASH_WGMMA_HEAD_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128))
TOPK_BN = 128        # catalog rows of an l2_topk tile
_TOPK_DK, _TOPK_STAGES = 64, 2  # l2_topk's chunk depth and ring (l2_topk.cu)
_PQ_THREADS = 256    # threads of a pq_adc block, one slot each at a time
# pq_adc_lists: shared memory an SM holds; blocks a launch is aimed at (two
# an SM); a list's groups of queries spread over up to _PQ_SPREAD times the
# blocks the batch's average list needs (at most 8)
_SM_SMEM, _PQ_LISTS_TARGET_BLOCKS, _PQ_SPREAD = 233472, 2 * 132, 2


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SHAPE_LAUNCHES.clear()


def l2_topk_key(nq: int, n: int, d: int, k: int) -> tuple:
    """The shape an `l2_topk` launch is counted under: (Q, N, D, k)."""
    return (nq, n, d, k)


def pq_adc_key(b: int, p: int, m: int, c: int) -> tuple:
    """The shape a `pq_adc` launch is counted under: (B, P, M, C), P = N for
    the dense form."""
    return (b, p, m, c)


def flash_key(q_shape, k_shape, causal: bool, window: int, written_upto: int,
              dv: int | None = None) -> tuple:
    """The shape a flash launch is counted under: (B, S, T, H, KV, Dk, Dv,
    mask kind), Dv = Dk unless given, the kind "causal" or "full",
    "+window" with a sliding window and "+written_upto" when keys at or
    past written_upto (< T) are masked."""
    b, s, h, d = q_shape
    t, kvh = k_shape[1], k_shape[2]
    kind = ("causal" if causal else "full") + ("+window" if window else "") + (
        "+written_upto" if written_upto < t else "")
    return (b, s, t, h, kvh, d, d if dv is None else dv, kind)


def _device(*tensors) -> str:
    """"cuda" when every tensor lies on one CUDA device, "cpu" when all lie
    on the CPU, "meta" when all are meta tensors; raises on a mix or on
    any other device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"kernel inputs on unsupported device {dev}")
    return dev.type


def _launch_or_meta(meta: bool, kernel: str, shape: tuple, work: cost.Work, launch) -> None:
    """launch() and count it in LAUNCHES and under `shape` in
    SHAPE_LAUNCHES, or on meta tensors launch nothing; either way add the
    kernel's `work` to the open cost records."""
    if not meta:
        launch()
        LAUNCHES[kernel] += 1
        SHAPE_LAUNCHES[(kernel, shape)] += 1
    cost.add_launch(kernel, work)


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
            f"{kernel}: k = {k} is above the CUDA kernels' cap of {MAX_K} "
            f"(ops.MAX_K, topk_common.cuh's TOPK_MAX_K)")


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


def pairwise_l2_skinny_smem_bytes_host(qm: int, d: int) -> int:
    """A host copy of pairwise_l2.cu's `skinny_smem_bytes`: qm queries of
    D rounded up to 64 columns, their norms (qm rounded up to 4, so the
    rings start on 16 bytes), and each warp's ring.
    chip_smoke.py holds it equal to the library's."""
    dpad = -(-d // _SK_DK) * _SK_DK
    return 4 * (qm * dpad + -(-qm // 4) * 4 + _SK_WARPS * _SK_STAGES * _SK_ROWS * _SK_LD)


def pairwise_l2_plan(nq: int, n: int, d: int, m: int = 1,
                     streamable: bool = True) -> tuple[str, int, int]:
    """(kind, qm, blocks) of a `pairwise_l2` launch over m pairs, chosen
    from the shape (pairwise_l2.cu says why):
      - "skinny" for a streamable pair (one contiguous pair whose catalog
        starts on 16 bytes, for cp.async's 16-byte pieces) of at most
        SKINNY_MAX_Q queries of a width divisible by 4, when the queries
        fit shared memory beside the rings: qm is the template's bound on
        Q (a power of two), blocks the persistent grid (a block an SM at
        most);
      - else "tile64" (64 x 64 tiles) when those tiles alone fill the 132
        SMs, "tile32" (32 x 32) when they do not; blocks is the grid.
        Where 64 x 64 tiles fill the SMs, 32 x 32 ones are 1.5-1.6x
        slower on an H100 (half the reuse of each staged element; 64 x
        16384 x 128, 64 x 16384 x 1024, 1M x 256 x 128:
        `scripts/kernel_shapes.py --designs`, PERF.md)."""
    if m == 1 and streamable and nq <= SKINNY_MAX_Q and d % 4 == 0:
        qm = 1 << max(nq - 1, 0).bit_length()
        if pairwise_l2_skinny_smem_bytes_host(qm, d) <= SMEM_LIMIT:
            tiles = -(-n // _SK_ROWS)
            return "skinny", qm, min(-(-tiles // _SK_WARPS), _SMS)
    grid64 = -(-nq // 64) * -(-n // 64) * m
    if grid64 >= _SMS:
        return "tile64", 0, grid64
    return "tile32", 0, -(-nq // 32) * -(-n // 32) * m


def _pairwise_launch(q, x, out, nq, n, d, m, strides, kind, qm, blocks):
    if -(-nq // (64 if kind == "tile64" else 32)) > 65535 or m > 65535:
        raise NotImplementedError(f"pairwise_l2: Q = {nq}, M = {m} exceed the grid")
    rc = _build.load("pairwise_l2").pairwise_l2(
        q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, n, d, m, *strides,
        PAIRWISE_KINDS[kind], qm, blocks, _stream())
    _raise_on(rc, "pairwise_l2")


def pairwise_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D), (N, D) -> (Q, N) float32 squared L2 distances, clamped at 0.

    CUDA: float32 contiguous inputs, the `pairwise_l2` kernel in the design
    `pairwise_l2_plan` picks from the shape (IEEE float32 FMAs in every
    one, bitwise the same sums)."""
    dev = _device(q, x)
    if dev == "cpu":
        return ref.pairwise_l2_ref(q, x)
    _ieee_fp32()
    _check("pairwise_l2 q", q, torch.float32, 2)
    _check("pairwise_l2 x", x, torch.float32, 2)
    if q.shape[1] != x.shape[1]:
        raise ValueError(f"pairwise_l2: depth mismatch {tuple(q.shape)} vs "
                         f"{tuple(x.shape)}")
    nq, n, d = q.shape[0], x.shape[0], q.shape[1]
    out = torch.empty((nq, n), dtype=torch.float32, device=q.device)
    if nq and n:
        def launch():
            kind, qm, blocks = pairwise_l2_plan(nq, n, d, 1, x.data_ptr() % 16 == 0)
            _pairwise_launch(q, x, out, nq, n, d, 1, (0, d, 0, n, 0), kind, qm, blocks)

        _launch_or_meta(dev == "meta", "pairwise_l2", (nq, n, d),
                        cost.pairwise_l2(nq, n, d), launch)
    return out


def pairwise_l2_batched(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M pairs at once: q (M, Q, d), x (M, C, d) -> (Q, M, C) float32,
    out[:, i] = pairwise_l2(q[i], x[i]) (the PQ distance tables: subspace
    i's requests against codebook i, in adc_lut's layout).

    CUDA: one launch with grid z = M; q may be a strided view whose rows
    are contiguous (the (M, B, d) view of (B, M * d) requests), x
    contiguous.  Counted as a `pairwise_l2` launch."""
    dev = _device(q, x)
    if dev == "cpu":
        return ref.pairwise_l2_batched_ref(q, x)
    _ieee_fp32()
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"pairwise_l2_batched: float32 inputs, got {q.dtype}, {x.dtype}")
    if q.dim() != 3 or x.dim() != 3 or q.shape[0] != x.shape[0] or q.shape[2] != x.shape[2]:
        raise ValueError(f"pairwise_l2_batched: shapes q {tuple(q.shape)}, "
                         f"x {tuple(x.shape)}")
    if q.stride(2) != 1 or not x.is_contiguous():
        raise ValueError("pairwise_l2_batched: q's rows and x must be contiguous")
    m, nq, d = q.shape
    c = x.shape[1]
    out = torch.empty((nq, m, c), dtype=torch.float32, device=q.device)
    if m and nq and c:
        def launch():
            # the tiles read q through strides; skinny takes one contiguous pair
            kind, qm, blocks = pairwise_l2_plan(nq, c, d, m, streamable=False)
            _pairwise_launch(q, x, out, nq, c, d, m,
                             (q.stride(0), q.stride(1), c * d, m * c, c), kind, qm, blocks)

        _launch_or_meta(dev == "meta", "pairwise_l2", (nq, c, d, m),
                        cost.pairwise_l2(nq, c, d, m), launch)
    return out


def l2_topk_smem_bytes_host(qt: int, d: int, k: int) -> int:
    """A host copy of l2_topk.cu's `smem_bytes`: 1 KB of alignment, a ring
    of _TOPK_STAGES 64-deep chunks (TOPK_BN catalog rows, and the TF32 hi
    and lo halves of 16 qt queries) with two mbarriers a stage, the norms
    and the lists; D does not enter, the depth is streamed.  It lets the launch plan be checked without a card;
    chip_smoke.py holds it equal to the library's `l2_topk_smem_bytes`.
    The wrapper itself asks the library."""
    bq = 16 * qt
    return (1024 + _TOPK_STAGES * (TOPK_BN + 2 * bq) * _TOPK_DK * 4 + 16 * _TOPK_STAGES
            + 4 * (bq + TOPK_BN + 2 * bq * k))


def topk_l2_query_tile(nq: int, d: int, k: int, smem_bytes) -> int:
    """qt of an `l2_topk` launch (a block holds 16 * qt queries): the
    widest of 1, 2, 4 that the batch fills and whose shared memory,
    `smem_bytes(qt, d, k)`, fits a block (the lists take 8 * 16 qt * k
    bytes: k 400 fits 32 queries, k 1024 16).  Raises NotImplementedError
    when even qt = 1 does not fit (no (d, k <= MAX_K) does: the kernel
    streams the depth)."""
    qt = 1 if nq <= 16 else 2 if nq <= 32 else 4
    while qt > 1 and smem_bytes(qt, d, k) > SMEM_LIMIT:
        qt //= 2
    if smem_bytes(qt, d, k) > SMEM_LIMIT:
        raise NotImplementedError(
            f"topk_l2: D = {d}, k = {k} need more shared memory than a block "
            f"has, even at 16 queries a block")
    return qt


def topk_l2_plan(nq: int, n: int, d: int, k: int, smem_bytes) -> tuple[int, int, int]:
    """(qt, chunk, nchunks) of an `l2_topk` launch: the query tile
    (`topk_l2_query_tile`), and runs of whole 128-row tiles for about one
    wave of blocks, two an SM at a 16-query tile."""
    qt = topk_l2_query_tile(nq, d, k, smem_bytes)
    qtiles = -(-nq // (16 * qt))
    target = max(1, _TOPK_TARGET_BLOCKS * (2 if qt == 1 else 1) // qtiles)
    chunk = max(TOPK_BN, -(-n // target))
    chunk = -(-chunk // TOPK_BN) * TOPK_BN
    return qt, chunk, -(-n // chunk)


def topk_l2_bound(q: torch.Tensor, qn: torch.Tensor, x: torch.Tensor, k: int,
                  valid=None):
    """(Q,) float32: per query, a distance that no row `l2_topk` returns
    exceeds, or None below TOPK_SAMPLE_MIN_N rows (there the sample would
    be a large share of the catalog).  qn (Q,) are the queries' squared
    norms.

    tau, the k-th smallest distance of the first TOPK_SAMPLE (live) rows by
    `pairwise_l2`, is widened by what both kernels' float32 sums may err on
    those k rows: the k-th distance l2_topk computes over the whole catalog
    is at most the largest it computes over them.  Each sum errs by at most
    about (3 D + 8) 2^-24 (|q|^2 + |x|^2) (l2_topk's truncating tensor-core
    sums; pairwise_l2's float32 FMAs err less), and such a row has
    |x|^2 <= 2 |q|^2 + 2 (tau + its error), so (8 D + 128) 2^-24
    (3 |q|^2 + 2 tau) covers both sums without any row's norm.  Rows beyond
    the bound never enter a list, so the kernel inserts about
    k N / TOPK_SAMPLE rows a query, not k (1 + ln(run / k)) in every block.
    +inf where the sample holds fewer than k live rows (no bound)."""
    n, d = x.shape
    if n < TOPK_SAMPLE_MIN_N:
        return None
    dist = pairwise_l2(q, x[:TOPK_SAMPLE])
    if valid is not None:
        dist = dist.masked_fill(~valid[None, :TOPK_SAMPLE], float("inf"))
    tau = torch.topk(dist, k, dim=1, largest=False, sorted=True).values[:, -1]
    return (tau + (8 * d + 128) * 2.0 ** -24 * (3 * qn + 2 * tau)).contiguous()


def tf32_split(a: torch.Tensor):
    """(hi, lo), float32, with a = hi + lo up to the dropped low bits of lo:
    each rounded to TF32 (a 10-bit mantissa, to nearest with ties away from
    zero, as cvt.rna.tf32.f32).  l2_topk's queries go to the kernel split."""
    def rna(v):
        return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(a)
    return hi, rna(a - hi)


def _tma_ready(a: torch.Tensor) -> torch.Tensor:
    """a, or a copy zero-padded to a width divisible by 4 and starting on
    16 bytes: TMA's rows must be 16-byte multiples (zero columns add
    nothing to a distance)."""
    if a.shape[1] % 4 == 0 and a.data_ptr() % 16 == 0:
        return a
    return torch.nn.functional.pad(a, (0, -a.shape[1] % 4)).contiguous()


def topk_l2(q: torch.Tensor, x: torch.Tensor, k: int, *, valid=None):
    """Fused distance + top-k: (dists (Q, k) ascending, ids (Q, k) int32).

    `valid` (N,) bool is the tombstone mask: masked rows never surface.
    Slots past the live rows underflow as +inf / -1, k > N included (both
    devices return k columns).  On CUDA the (Q, N) distance matrix never
    reaches device memory; k <= MAX_K (larger k raises NotImplementedError).
    The kernel's lists start as +inf / -1 and only finite distances enter
    them, so a merged id is -1 exactly where its distance is +inf, with or
    without `valid`.  A catalog whose width is not a multiple of 4, or that
    does not start on 16 bytes, is copied padded first (TMA's rows are
    16-byte multiples)."""
    dev = _device(q, x, *([] if valid is None else [valid]))
    if dev == "cpu":
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
    meta = dev == "meta"
    lib = None if meta else _build.load("l2_topk")
    qt, chunk, nchunks = topk_l2_plan(nq, n, d, k, l2_topk_smem_bytes_host if meta
                                      else lib.l2_topk_smem_bytes)
    if nchunks > 65535:
        raise NotImplementedError(f"topk_l2: N = {n} exceeds the grid")
    qn = torch.sum(q * q, dim=1)  # as the plain version sums them
    bound = topk_l2_bound(q, qn, x, k, valid)
    xk, qk = _tma_ready(x), _tma_ready(q)
    q_hi, q_lo = tf32_split(qk)
    pd = torch.empty((nq, nchunks * k), dtype=torch.float32, device=q.device)
    pi = torch.empty(pd.shape, dtype=torch.int32, device=q.device)
    def launch():
        rc = lib.l2_topk_partial(
            q_hi.data_ptr(), q_lo.data_ptr(), qn.data_ptr(), xk.data_ptr(),
            None if valid is None else valid.data_ptr(),
            None if bound is None else bound.data_ptr(), pd.data_ptr(), pi.data_ptr(),
            nq, n, xk.shape[1], k, chunk, nchunks, qt, _stream())
        _raise_on(rc, "l2_topk")

    _launch_or_meta(meta, "l2_topk", l2_topk_key(nq, n, d, k),
                    cost.l2_topk(nq, n, d, k, masked=valid is not None), launch)
    return _merge_partials(pd, pi, k)


def topk_l2_fused(q: torch.Tensor, x: torch.Tensor, k: int, *, chunk: int,
                  valid=None):
    """`topk_l2` that never forms the (Q, N) matrix on either device (port
    of the reference's `topk_l2_fused` / `topk_l2_chunked`): on CUDA the
    `l2_topk` kernel (counted under `l2_topk`), on the CPU the plain
    version scanning `chunk` catalog rows at a time.  Same outputs and
    tail conventions as `topk_l2`."""
    if _device(q, x, *([] if valid is None else [valid])) == "cpu":
        return ref.l2_topk_chunked_ref(q, x, k, chunk, valid)
    return topk_l2(q, x, k, valid=valid)


def ivf_scan_smem_bytes_host(d: int) -> int:
    """A host copy of ivf_scan.cu's `smem_bytes`: 2 * IVF_PASS 64-bit keys
    (the kept k and a pass's new ones), a pass's IVF_PASS ids and the
    query's D floats.  chip_smoke.py holds it equal to the library's."""
    return 8 * 2 * IVF_PASS + 4 * IVF_PASS + 4 * d


def ivf_scan_plan(b: int, p: int, k: int) -> tuple[int, int, int]:
    """(blocks a query, run, cluster size) of an `ivf_scan` launch: the
    table is split into equal runs of at least IVF_MIN_RUN slots over a
    cluster of up to IVF_MAX_CLUSTER blocks, one run a block (walked in
    passes of IVF_PASS slots where it is longer), whose k-lists are merged
    inside the launch through distributed shared memory.  A block's time is
    a chain of dependent reads (ids, then rows, IVF_MIN_RUN rows in flight
    a block), so the IVF-PQ re-rank's 256 slots take 4 blocks of one round
    each, not one block of four.  Every k up to MAX_K fits a pass's keys
    beside the kept ones.  Host arithmetic; b does not enter (a cluster is
    a query's)."""
    _check_k("ivf_scan_topk", k)
    if b < 1 or p < 1:
        raise ValueError(f"ivf_scan_plan: B = {b}, P = {p}")
    c = min(IVF_MAX_CLUSTER, -(-p // IVF_MIN_RUN))
    return c, -(-p // c), c


def ivf_scan_topk(q: torch.Tensor, x: torch.Tensor, cand: torch.Tensor, k: int,
                  *, valid=None):
    """Fused gather + L2 + top-k over per-query candidate ids.

    q (B, D), x (N, D), cand (B, P) int32 with -1 = invalid slot.  Returns
    (dists (B, k), ids (B, k) int32), ties to the lowest position;
    underflowing slots (fewer than k valid candidates, including k > P)
    come back as +inf / -1.  `valid` (N,) bool marks live rows: a
    tombstoned id is an invalid slot.  On CUDA one `ivf_scan` launch
    (`ivf_scan_plan`) returns the final outputs, the tombstones read in the
    kernel; k <= MAX_K (larger k raises NotImplementedError)."""
    dev = _device(q, x, cand, *([] if valid is None else [valid]))
    if dev == "cpu":
        return ref.ivf_scan_ref(q, x, cand, k, valid)
    _ieee_fp32()
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
    if valid is not None:
        _check("ivf_scan_topk valid", valid, torch.bool, 1)
        if valid.shape[0] != x.shape[0]:
            raise ValueError("ivf_scan_topk: valid must have one entry per row")
    if ivf_scan_smem_bytes_host(d) > SMEM_LIMIT:
        raise NotImplementedError(
            f"ivf_scan_topk: D = {d} needs more shared memory than a block has")
    _, run, cluster = ivf_scan_plan(b, p, k)
    dists = torch.empty((b, k), dtype=torch.float32, device=q.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=q.device)
    def launch():
        rc = _build.load("ivf_scan").ivf_scan_topk(
            q.data_ptr(), x.data_ptr(), cand.data_ptr(),
            None if valid is None else valid.data_ptr(), dists.data_ptr(), ids.data_ptr(),
            b, x.shape[0], d, p, k, run, cluster, int(d % 4 == 0 and x.data_ptr() % 16 == 0),
            _stream())
        _raise_on(rc, "ivf_scan")

    _launch_or_meta(dev == "meta", "ivf_scan", (b, p, d, k), cost.ivf_scan(b, p, d, k),
                    launch)
    return dists, ids


def invlist_lengths(invlists: torch.Tensor) -> torch.Tensor:
    """(nlist,) int32: each inverted list's true length, one past its last
    id >= 0 (lists are padded with -1 at the tail; a -1 before the last id,
    a folded tombstone, stays inside the length)."""
    nlist, cap = invlists.shape
    if cap == 0:
        return torch.zeros(nlist, dtype=torch.int32, device=invlists.device)
    slot = torch.arange(1, cap + 1, dtype=torch.int32, device=invlists.device)
    return torch.amax(torch.where(invlists >= 0, slot, torch.zeros_like(slot)),
                      dim=1).to(torch.int32).contiguous()


def ivf_scan_lists_smem_bytes_host(d: int, vec4: int, k: int) -> int:
    """A host copy of ivf_scan_lists.cu's `smem_bytes`: the 2-stage ring of
    32-row tiles (rows padded to an odd count of 16-byte pieces, or of
    floats), 8 queries, the warps' partial sums, the tiles' ids, and 8
    lists of k rounded up to a power of two (at least 32) pairs.
    chip_smoke.py holds it equal to the library's."""
    ld = 4 * ((d // 4) | 1) if vec4 else (d | 1)
    kpow = max(32, 1 << max(k - 1, 0).bit_length())
    return 4 * (2 * 32 * ld + 8 * d + 8 * 8 * 32) + 4 * 2 * 32 + 8 * 8 * kpow


def ivf_lists_plan(nlist: int, cap: int, nprobe: int, k: int) -> tuple[int, int]:
    """(nruns, run) of an `ivf_scan_lists` launch: each list is cut into
    nruns runs of `run` slots, for about _LISTS_TARGET_BLOCKS blocks (a
    block's warps each walk their query's whole run) but runs of at least
    _LISTS_MIN_RUN * k slots, and no more than _MERGE_MAX_WIDTH partials a
    query (nprobe * nruns * k, which the merge sorts: PyTorch sorts rows
    of up to 4096 in one block, longer ones by a segmented radix sort of
    several launches; at 16 probes and k 64, 5 runs a list made the call
    at B 8 slower than the per-query kernel's, 4 runs faster at every B
    from 1 to 64: `scripts/kernel_shapes.py --designs`, PERF.md).  Only
    static numbers enter, so the grid needs nothing from the device."""
    nruns = max(1, min(-(-_LISTS_TARGET_BLOCKS // max(nlist, 1)),
                       cap // (_LISTS_MIN_RUN * k),
                       _MERGE_MAX_WIDTH // max(nprobe * k, 1)))
    return nruns, -(-cap // nruns)


# the (B, nprobe * cap) ids of the probed lists (an entry outside [0, nlist)
# gives only -1): the plain versions' table
probed_table = ref.probed_table


def ivf_probe_kernel_for(d: int) -> str:
    """The kernel an IVF probe at width d takes on the card:
    "ivf_scan_lists" (list-major, each probed row read once for the batch)
    up to IVF_LISTS_MAX_D columns (its ring of 32-row tiles and 8 queries
    fit shared memory there), else "ivf_scan" over the (B, nprobe * cap)
    table."""
    return "ivf_scan_lists" if d <= IVF_LISTS_MAX_D else "ivf_scan"


def ivf_scan_lists(q: torch.Tensor, x: torch.Tensor, invlists: torch.Tensor,
                   probe: torch.Tensor, k: int, *, valid=None, lens=None):
    """The IVF probe: the top k of the probed lists' rows for each query.

    q (B, D), x (N, D), invlists (nlist, cap) int32 padded with -1, probe
    (B, nprobe) the lists each query scans (an entry outside [0, nlist)
    scans nothing).  Returns exactly what `ivf_scan_topk(q, x,
    probed_table(invlists, probe), k, valid=valid)` returns: the same ids,
    ties to the lowest position r * cap + slot, +inf / -1 on underflow; on
    the CPU it is that call.
    `lens` (nlist,) int32 are the lists' true lengths (`invlist_lengths`,
    computed when None).

    CUDA: `ivf_probe_kernel_for` picks the kernel from the shape:
    `ivf_scan_lists` (a block a run of a list, reading its rows once for
    every query that probes it), or at D > IVF_LISTS_MAX_D the per-query
    `ivf_scan` over the gathered table.  k <= MAX_K."""
    b = q.shape[0]
    dev = _device(q, x, invlists, probe, *([] if valid is None else [valid]),
                  *([] if lens is None else [lens]))
    if dev == "cpu":
        return ivf_scan_topk(q, x, probed_table(invlists, probe), k, valid=valid)
    _ieee_fp32()
    _check_k("ivf_scan_lists", k)
    _check("ivf_scan_lists q", q, torch.float32, 2)
    _check("ivf_scan_lists x", x, torch.float32, 2)
    _check("ivf_scan_lists invlists", invlists, torch.int32, 2)
    if probe.dim() != 2 or probe.shape[0] != b or x.shape[1] != q.shape[1]:
        raise ValueError(f"ivf_scan_lists: shapes q {tuple(q.shape)}, x "
                         f"{tuple(x.shape)}, probe {tuple(probe.shape)}")
    d = q.shape[1]
    nlist, cap = invlists.shape
    nprobe = probe.shape[1]
    if b == 0 or nprobe * cap == 0:
        raise ValueError(f"ivf_scan_lists: empty input, B = {b}, P = {nprobe * cap}")
    if ivf_probe_kernel_for(d) == "ivf_scan":
        return ivf_scan_topk(q, x, probed_table(invlists, probe), k, valid=valid)
    if valid is not None:
        _check("ivf_scan_lists valid", valid, torch.bool, 1)
        if valid.shape[0] != x.shape[0]:
            raise ValueError("ivf_scan_lists: valid must have one entry per row")
    lens = invlist_lengths(invlists) if lens is None else lens
    _check("ivf_scan_lists lens", lens, torch.int32, 1)
    if lens.shape[0] != nlist:
        raise ValueError(f"ivf_scan_lists: {lens.shape[0]} lengths for {nlist} lists")
    probe = probe.to(torch.int32).contiguous()
    meta = dev == "meta"
    lib = None if meta else _build.load("ivf_scan_lists")
    nruns, run = ivf_lists_plan(nlist, cap, nprobe, k)
    vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
    smem = ivf_scan_lists_smem_bytes_host if meta else lib.ivf_scan_lists_smem_bytes
    if smem(d, vec4, k) > SMEM_LIMIT:
        raise NotImplementedError(f"ivf_scan_lists: D = {d}, k = {k} need more shared "
                                  f"memory than a block has")
    if nlist * nruns >= 2 ** 31:
        raise NotImplementedError(f"ivf_scan_lists: {nlist} lists exceed the grid")
    width = nprobe * nruns * k
    buf = torch.empty(b * (width + 1), dtype=torch.float32, device=q.device)
    # the partials, and each query's bound on its k-th distance (scratch)
    pd, bound = buf[:b * width].view(b, width), buf[b * width:]
    pi = torch.empty((b, width), dtype=torch.int32, device=q.device)
    def launch():
        rc = lib.ivf_scan_lists(
            q.data_ptr(), x.data_ptr(), invlists.data_ptr(), lens.data_ptr(),
            probe.data_ptr(), None if valid is None else valid.data_ptr(), pd.data_ptr(),
            pi.data_ptr(), bound.data_ptr(), b, x.shape[0], d, nlist, cap, nprobe, k, nruns,
            run, vec4, _stream())
        _raise_on(rc, "ivf_scan_lists")

    _launch_or_meta(meta, "ivf_scan_lists", (b, nprobe, cap, d, k),
                    cost.ivf_scan_lists(b, nprobe, cap, d, k, nlist=nlist,
                                        mask_bytes=0 if valid is None else b * nprobe * cap),
                    launch)
    vals, ids = _merge_partials(pd, pi, k)
    ids = torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))
    return vals, ids


def pq_adc_chunks(b: int, p: int) -> tuple[int, int]:
    """(run of P per block, blocks per query) of a `pq_adc` launch: enough
    blocks for a few waves over the SMs, each run a whole number of block
    widths.  Every block loads its query's LUT once for its run."""
    target = max(1, _TARGET_BLOCKS * 2 // max(b, 1))
    chunk = max(_PQ_THREADS, -(-p // target))
    chunk = -(-chunk // _PQ_THREADS) * _PQ_THREADS
    return chunk, -(-p // chunk)


def _pq_adc_launch(lut: torch.Tensor, codes: torch.Tensor, cand, meta: bool = False):
    """Checks and one `pq_adc` launch (on meta tensors its outputs only);
    cand None is the dense form."""
    _check("pq_adc lut", lut, torch.float32, 3)
    _check("pq_adc codes", codes, torch.uint8, 2)
    b, m, c = lut.shape
    n = codes.shape[0]
    if codes.shape[1] != m:
        raise ValueError(f"pq_adc: lut {tuple(lut.shape)} and codes "
                         f"{tuple(codes.shape)} differ in M")
    p = n
    if cand is not None:
        _check("pq_adc cand", cand, torch.int32, 2)
        p = cand.shape[1]
        if cand.shape[0] != b:
            raise ValueError(f"pq_adc: lut {tuple(lut.shape)} and cand "
                             f"{tuple(cand.shape)} differ in B")
    if c > PQ_MAX_C:
        raise NotImplementedError(f"pq_adc: C = {c} > {PQ_MAX_C} does not fit "
                                  f"the kernel's uint8 codes")
    lib = None if meta else _build.load("pq_adc")
    if not meta and lib.pq_adc_smem_bytes(m, c) > SMEM_LIMIT:
        raise NotImplementedError(
            f"pq_adc: an M = {m} x C = {c} LUT needs more shared memory than "
            f"a block has")
    if b > 65535:
        raise NotImplementedError(f"pq_adc: B = {b} exceeds the grid")
    out = torch.empty((b, p), dtype=torch.float32, device=lut.device)
    if b == 0 or p == 0:
        return out
    def launch():
        chunk, nchunks = pq_adc_chunks(b, p)
        vec8 = int(m % 8 == 0 and codes.data_ptr() % 8 == 0)
        rc = lib.pq_adc(lut.data_ptr(), codes.data_ptr(),
                        None if cand is None else cand.data_ptr(), out.data_ptr(),
                        b, n, m, c, p, chunk, nchunks, vec8, _stream())
        _raise_on(rc, "pq_adc")

    _launch_or_meta(meta, "pq_adc", pq_adc_key(b, p, m, c),
                    cost.pq_adc(b, p, m, c, ndistinct=n if cand is None else None), launch)
    return out


def pq_adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """PQ asymmetric distances: lut (Q, M, C) float32, codes (N, M) ->
    (Q, N) float32, dist[q, n] = Σ_m lut[q, m, codes[n, m]], summed in m
    order (bitwise the plain version's for the same LUT).

    CUDA: contiguous float32 LUT with C <= 256, uint8 codes, the `pq_adc`
    kernel."""
    dev = _device(lut, codes)
    if dev == "cpu":
        return ref.pq_adc_ref(lut, codes)
    return _pq_adc_launch(lut, codes, None, dev == "meta")


def pq_adc_gather(lut: torch.Tensor, codes: torch.Tensor,
                  cand: torch.Tensor) -> torch.Tensor:
    """The ADC scan of a batch at its candidate rows, in one launch: lut
    (B, M, C) float32, codes (N, M), cand (B, P) int32 with -1 = invalid
    slot -> (B, P) float32, +inf on -1 slots.  The kernel reads each
    slot's code row from `codes` itself; no (B, P, M) copy is made.

    CUDA: as `pq_adc`, with contiguous int32 cand."""
    dev = _device(lut, codes, cand)
    if dev == "cpu":
        return ref.pq_adc_gather_ref(lut, codes, cand)
    return _pq_adc_launch(lut, codes, cand, dev == "meta")


def codes_by_list(codes: torch.Tensor, invlists: torch.Tensor) -> torch.Tensor:
    """(nlist, ccap, M) uint8: the code rows list-major, [l, s] =
    codes[invlists[l, s]] at every listed slot, 0 at -1 slots and past cap;
    ccap is cap rounded up to even, so at M 8 a 16-byte load of two rows
    stays aligned (`pq_shortlist_lists` reads them so)."""
    nlist, cap = invlists.shape
    out = torch.zeros((nlist, cap + cap % 2, codes.shape[1]), dtype=torch.uint8,
                      device=codes.device)
    ids = invlists.long()
    rows = codes[ids.clamp(0, max(codes.shape[0] - 1, 0))]
    out[:, :cap] = torch.where((ids >= 0)[..., None], rows, torch.zeros_like(rows))
    return out


def pq_lists_smem_bytes_host(gmax: int, m: int, c: int, run: int, kp: int) -> int:
    """A host copy of pq_adc_lists.cu's `smem_bytes`: a group's gmax LUTs
    (M x C floats each), its keys (a run's slots each), histograms (256
    bins each) and kept slots (kp = min(kk, run) each).  chip_smoke.py holds
    it equal to the library's."""
    return 4 * gmax * (m * c + run + 256 + kp)


def pq_lists_plan(nlist: int, cap: int, nprobe: int, kk: int, m: int, c: int,
                  b: int = 1) -> tuple[int, int, int, int]:
    """(nruns, run, gmax, qsplit) of a `pq_shortlist_lists` launch over a
    batch of b queries.  Each list is cut into nruns runs of `run` slots
    (even), for about _PQ_LISTS_TARGET_BLOCKS blocks, but no run shorter
    than kk (a run keeps kk of its slots) and no more than _MERGE_MAX_WIDTH
    partials a query (nprobe * nruns * kk, which the merge sorts in one
    block, as `ivf_lists_plan` caps them); more runs only where one run's
    keys do not fit shared memory beside a LUT.  gmax, the queries a block
    holds at once, is the largest of 8, 4, 2, 1 whose block leaves room
    for a second one on its SM, else the largest that fits.  qsplit blocks
    share each (list, run), one taking every qsplit-th group of the
    queries probing the list: _PQ_SPREAD times the groups the batch's
    average list holds (b * nprobe / nlist / gmax), at most 8 and at most
    the groups b queries make, so the lists many queries probe do not hold
    the grid up (`scripts/kernel_shapes.py --designs pq_adc_lists` times
    the alternatives).  Only static numbers enter, so the grid needs
    nothing from the device."""
    nruns = max(1, min(-(-_PQ_LISTS_TARGET_BLOCKS // max(nlist, 1)),
                       cap // max(kk, 1),
                       _MERGE_MAX_WIDTH // max(nprobe * kk, 1)))
    while True:
        run = -(-cap // nruns)
        run += run % 2
        sizes = [(g, pq_lists_smem_bytes_host(g, m, c, run, min(kk, run)))
                 for g in (8, 4, 2, 1)]
        fits = [g for g, size in sizes if 2 * (size + 1024) <= _SM_SMEM] or [
            g for g, size in sizes if size <= SMEM_LIMIT]
        if fits:
            gmax = fits[0]
            qsplit = max(1, min(8, -(-b // gmax),
                                -(-_PQ_SPREAD * b * nprobe // (max(nlist, 1) * gmax))))
            return nruns, run, gmax, qsplit
        if run <= 2:
            raise NotImplementedError(f"pq_shortlist_lists: an M = {m} x C = {c} LUT "
                                      f"needs more shared memory than a block has")
        nruns += 1


def pq_shortlist_lists(lut: torch.Tensor, codes_lists: torch.Tensor,
                       invlists: torch.Tensor, probe: torch.Tensor, kk: int, *,
                       valid=None, lens=None):
    """The IVF-PQ shortlist: (ADC distances (B, kk), ids (B, kk) int32), the
    stable top kk of the probed lists' slots by ADC distance, exactly
    `ref.pq_shortlist_ref` (its plain version, which the CPU runs): ties to
    the lowest position r * cap + slot, +inf / -1 where the probed slots
    run out, an entry of probe outside [0, nlist) scans nothing, `valid`
    (N,) bool folds tombstones to -1 slots.

    lut (B, M, C) float32; codes_lists (nlist, ccap, M) uint8, the code rows
    list-major (`codes_by_list`); invlists (nlist, cap) int32 padded with
    -1; probe (B, nprobe); `lens` (nlist,) int32 the lists' true lengths
    (`invlist_lengths`, computed when None).

    CUDA: one `pq_adc_lists` launch (a block a run of a list, its code rows
    read once for every query that probes it, the run's kk best kept in
    the kernel) and a stable sort of each query's nprobe * nruns * kk
    partials (`pq_lists_plan`).  The kernel keeps no per-query list, so kk
    has no limit of its own; the sums are the plain version's, bit for
    bit, so its ids and distances equal the plain version's exactly."""
    dev = _device(lut, codes_lists, invlists, probe, *([] if valid is None else [valid]),
                  *([] if lens is None else [lens]))
    if dev == "cpu":
        return ref.pq_shortlist_ref(lut, codes_lists, invlists, probe, kk, valid)
    _check("pq_shortlist_lists lut", lut, torch.float32, 3)
    _check("pq_shortlist_lists codes_lists", codes_lists, torch.uint8, 3)
    _check("pq_shortlist_lists invlists", invlists, torch.int32, 2)
    b, m, c = lut.shape
    nlist, cap = invlists.shape
    if probe.dim() != 2 or probe.shape[0] != b or codes_lists.shape[0] != nlist or \
            codes_lists.shape[1] < cap or codes_lists.shape[2] != m:
        raise ValueError(f"pq_shortlist_lists: shapes lut {tuple(lut.shape)}, codes_lists "
                         f"{tuple(codes_lists.shape)}, invlists {tuple(invlists.shape)}, "
                         f"probe {tuple(probe.shape)}")
    nprobe = probe.shape[1]
    if b == 0 or nprobe * cap == 0:
        raise ValueError(f"pq_shortlist_lists: empty input, B = {b}, P = {nprobe * cap}")
    if kk < 1:
        raise ValueError(f"pq_shortlist_lists: kk must be >= 1, got {kk}")
    if c > PQ_MAX_C:
        raise NotImplementedError(f"pq_shortlist_lists: C = {c} > {PQ_MAX_C} does not fit "
                                  f"the kernel's uint8 codes")
    if valid is not None:
        _check("pq_shortlist_lists valid", valid, torch.bool, 1)
    # ids at or past N are dead only where `valid` says what N is
    n = 2 ** 31 - 1 if valid is None else valid.shape[0]
    lens = invlist_lengths(invlists) if lens is None else lens
    _check("pq_shortlist_lists lens", lens, torch.int32, 1)
    if lens.shape[0] != nlist:
        raise ValueError(f"pq_shortlist_lists: {lens.shape[0]} lengths for {nlist} lists")
    probe = probe.to(torch.int32).contiguous()
    meta = dev == "meta"
    lib = None if meta else _build.load("pq_adc_lists")
    nruns, run, gmax, qsplit = pq_lists_plan(nlist, cap, nprobe, kk, m, c, b)
    if nlist * nruns * qsplit >= 2 ** 31:
        raise NotImplementedError(f"pq_shortlist_lists: {nlist} lists exceed the grid")
    kp = min(kk, run)
    width = nprobe * nruns * kp
    buf = torch.empty(b * (width + 1), dtype=torch.float32, device=lut.device)
    # the partials, and each query's bound on its kk-th distance (scratch)
    pd, bound = buf[:b * width].view(b, width), buf[b * width:]
    pi = torch.empty((b, width), dtype=torch.int32, device=lut.device)
    ccap = codes_lists.shape[1]
    vec8 = int(m == 8 and ccap % 2 == 0 and run % 2 == 0
               and codes_lists.data_ptr() % 16 == 0)

    def launch():
        rc = lib.pq_adc_lists(
            lut.data_ptr(), codes_lists.data_ptr(), invlists.data_ptr(), lens.data_ptr(),
            probe.data_ptr(), None if valid is None else valid.data_ptr(), pd.data_ptr(),
            pi.data_ptr(), bound.data_ptr(), b, n, m, c,
            nlist, cap, ccap, nprobe, kp, nruns, run, gmax, qsplit, vec8, _stream())
        _raise_on(rc, "pq_adc_lists")

    _launch_or_meta(meta, "pq_adc_lists", (b, nprobe, cap, m, kk),
                    cost.pq_adc_lists(b, nprobe, cap, m, kk, c=c, nlist=nlist, width=width,
                                      masked=valid is not None), launch)
    vals, ids = _merge_partials(pd, pi, min(kk, width))
    if width < kk:  # kk beyond the probed slots: padded as the plain version
        return ref._underflow(vals, ids, kk)
    return vals, ids


def flash_kernel_for(dtype: torch.dtype, dk: int, dv: int | None = None) -> str:
    """The flash kernel a CUDA call takes, by (dtype, Dk, Dv), Dv = Dk
    unless given: bf16 at a pair of FLASH_WGMMA_HEAD_DIMS (the LM path's
    types and widths) -> "flash_attention_wgmma"; float32, and bf16 at
    the other pairs -> "flash_attention" (float32 FMA products)."""
    pair = (dk, dk if dv is None else dv)
    if dtype == torch.bfloat16 and pair in FLASH_WGMMA_HEAD_DIMS:
        return "flash_attention_wgmma"
    return "flash_attention"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    written_upto: int | None = None) -> torch.Tensor:
    """FlashAttention forward: q (B, S, H, Dk), k (B, T, KV, Dk), v (B, T,
    KV, Dv) -> (B, S, H, Dv) in q's dtype, with the reference's contract
    (`ref.flash_attention_ref`): logits scaled by 1 / sqrt(Dk), causal,
    sliding `window` (0 = full), absolute `q_offset` of q's first row,
    keys at or past `written_upto` (None = T) masked, GQA head h on kv
    head h // (H // KV), f32 accumulation, 0 for a row with no kept key.

    CUDA: contiguous float32 or bf16 tensors of one dtype, (Dk, Dv) in
    FLASH_HEAD_DIMS; anything else raises.  The kernel is chosen by
    (dtype, Dk, Dv), explicitly (`flash_kernel_for`):
      - bf16 at a pair of FLASH_WGMMA_HEAD_DIMS ((64, 64), (80, 80),
        (128, 128), (192, 128): the LM path's types and widths):
        `flash_attention_wgmma`, wgmma on the tensor cores with TMA-fed
        Q / K / V and p split into three bf16 parts; the tensors must
        start on 16 bytes (TMA);
      - float32 at any pair of FLASH_HEAD_DIMS, and bf16 at the others
        (the SMOKE and check widths (16, 16), (24, 16), (32, 32)):
        `flash_attention`, float32 FMA products (float32 is held to 1e-4,
        which tensor cores cannot promise).
    Either kernel raises when its build or launch fails; neither falls
    back to the other."""
    dev = _device(q, k, v)
    if dev == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, written_upto=written_upto)
    dtype = q.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: float32 or bf16 inputs, got {dtype}")
    _check("flash_attention q", q, dtype, 4)
    _check("flash_attention k", k, dtype, 4)
    _check("flash_attention v", v, dtype, 4)
    b, s, h, d = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if (d, dv) not in FLASH_HEAD_DIMS:
        raise NotImplementedError(f"flash_attention: (Dk, Dv) = ({d}, {dv}) is not one "
                                  f"of {FLASH_HEAD_DIMS}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: H = {h} is not a multiple of KV = {kvh}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window {window} and q_offset "
                         f"{q_offset} must be >= 0")
    if b > 65535 or h > 65535 or q_offset + s + t >= 2 ** 31:
        raise NotImplementedError(f"flash_attention: B = {b}, H = {h}, S = {s}, "
                                  f"T = {t} exceed the kernel's grid or positions")
    wu = t if written_upto is None else max(0, min(int(written_upto), t))
    out = torch.empty((b, s, h, dv), dtype=dtype, device=q.device)
    if not (b and s and h):
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h,
            kvh, d, dv, int(bool(causal)), int(window), int(q_offset), wu,
            1.0 / d ** 0.5)
    key = flash_key(q.shape, k.shape, causal, window, wu, dv)
    kernel = flash_kernel_for(dtype, d, dv)
    work = cost.flash_attention(b, s, t, h, kvh, d, dv, causal=bool(causal),
                                window=int(window), q_offset=int(q_offset), written_upto=wu,
                                itemsize=q.element_size())
    if kernel == "flash_attention":  # float32 FMA products, bf16 inputs included
        work = work._replace(peak=cost.FP32_FLOPS)
    if kernel == "flash_attention_wgmma" and dev != "meta" and any(
            a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k, v must start on 16 "
                         "bytes (the kernel loads them by TMA)")

    def launch():
        if kernel == "flash_attention_wgmma":
            rc = _build.load(kernel).flash_attention_wgmma(*args, _stream())
        else:
            rc = _build.load(kernel).flash_attention(*args, int(dtype == torch.bfloat16),
                                                     _stream())
        _raise_on(rc, kernel)

    _launch_or_meta(dev == "meta", kernel, key, work, launch)
    return out


# the profiler range of FlashAttentionFn's backward
FLASH_BACKWARD_RANGE = "flash_attention_backward"


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention` with a gradient, for the training forward.

    Forward: `flash_attention` (the kernel on a CUDA tensor, the plain
    version on the CPU); the kernel writes its output through a pointer,
    so without this Function the output has no grad_fn and q, k, v (and
    the weights before them) would get no gradient.  Backward: the
    reference has no backward kernel (it differentiates `_sdpa_flash`, a
    scan whose body is under `jax.checkpoint`), so neither does the port:
    the plain version is recomputed from the saved q, k, v with grad on,
    one KV chunk at a time under `torch.utils.checkpoint`, and
    differentiated by autograd, in float32 (IEEE float32 products on the
    card: `_ieee_fp32`).  The backward runs inside the profiler range
    FLASH_BACKWARD_RANGE, so a trace can attribute its device time.

    apply(q, k, v, causal, window, q_offset, written_upto, chunk)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int,
                written_upto: int | None, chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        written_upto=written_upto, chunk=chunk)
        return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               written_upto=written_upto)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        if q.is_cuda:
            _ieee_fp32()
        with torch.enable_grad(), torch.autograd.profiler.record_function(
                FLASH_BACKWARD_RANGE):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.flash_attention_ref(*leaves, checkpoint_chunks=True, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad_out)
        return dq, dk, dv, None, None, None, None, None


# the index layer's names: the dispatch is by tensor device, so the
# reference's backend-dispatching `*_auto` wrappers are these same functions
topk_l2_auto = topk_l2
ivf_scan_auto = ivf_scan_topk
