"""The cost record (`repro_torch.launch.cost`, `kernels.cost`, the dry-run's
`build_lowering` / `analyse`) against the reference's `hlo_analysis`.

- The five programs of tests/test_hlo_analysis.py, counted as the port
  runs them (a scan is a Python loop): FLOPs exactly the reference's;
  bytes exactly where nothing fuses (a matmul), and a loop's bytes an
  iteration exactly the reference's but its s32 loop counter, which an
  eager loop does not have.  Remat: the plain program's FLOPs exactly;
  the checkpointed one counts 3 dots more, the forward that runs once
  outside autograd and that the reference's dead-code elimination drops
  (`jax.grad` returns no loss value), both at least the plain count.
- The SMOKE cells (qwen1.5-0.5b, deepseek-v3 with MLA + MoE, mamba2, jamba,
  qwen2-vl; prefill, decode, train), `flops_per_device` of the port's
  `--smoke` record (a one-rank fake world, the (1, 1) mesh) against the
  reference's single-device `summarize(compiled.as_text()).flops` (its
  `jax.jit` of `make_prefill` / `make_decode_step` / `make_train_step`
  with no mesh: its mesh path does not compile under the installed JAX),
  to 0 (exactly) after one named term: the reference writes the SSD's
  decay factors into three-operand einsums (`bcqn,bchpn,bhcq->bcqhp`,
  `bcqs,bhcqs,bcshp->bcqhp`, `bcsn,bhcs,bcshp->bchpn`), so its backward
  takes each decay's gradient as a dot (2 B C Q H P, 2 B C Q^2 H and
  2 B C Q H P a Mamba2 layer, C = S / Q chunks, P the head width, which
  equals d_state at SMOKE), where the port multiplies the decay
  elementwise and sums its gradient as a reduction.
- The collectives a rank counts on a world-less mesh (meta tensors, a
  fake world of the mesh's size) against those the same step counts on a
  spawned gloo world of CPU ranks, at (1, 2) and (2, 2): calls and bytes
  by class, and FLOPs, exactly.
- The production AÇAI cell against a hand count: 2 b n_s d for the local
  scan, the merge, routing and projection gathers' and the metrics
  reductions' bytes.
- Each kernel wrapper's meta branch (the kernel's output shapes and
  dtypes, its work added, no launch counted), a CPU tensor still on the
  plain version; the bound column of PERF.md §6 from the package's
  formulas at every shape of its table.
- The faults the production cells found (ROADMAP C11, C12).
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import summarize
from repro_torch.configs import SMOKE_ARCHS, SMOKE_SHAPES
from repro_torch.kernels import cost as W
from repro_torch.kernels import ops, ref
from repro_torch.launch.cost import COLLECTIVES, CostMode
from repro_torch.models.model import layer_kind
from torch_dist_workers import cost_rank, run_world

N = 64
SDS = jax.ShapeDtypeStruct((N, N), jnp.float32)
DOT = 2.0 * N ** 3


def _ref(fn, *args):
    return summarize(jax.jit(fn).lower(*args).compile().as_text())


def _port(fn, *args):
    with CostMode(args) as mode:
        fn(*args)
    return mode.summary


def _mats(k=2):
    g = torch.Generator().manual_seed(0)
    return [torch.rand(N, N, generator=g) for _ in range(k)]


# --------------------------------------------------------------------------
# tests/test_hlo_analysis.py's programs
# --------------------------------------------------------------------------

def test_single_matmul_flops_and_bytes():
    want = _ref(lambda a, b: a @ b, SDS, SDS)
    got = _port(lambda a, b: a @ b, *_mats())
    assert got.flops == want.flops == DOT
    assert got.bytes == want.bytes == 4 * N * N


@pytest.mark.parametrize("outer,inner", [(9, 1), (5, 3)])
def test_scans_are_loops_counted_as_they_run(outer, inner):
    """A scan of `outer` steps (each a scan of `inner` matmuls when inner >
    1): the reference multiplies the body by its trip counts, the port runs
    every iteration."""
    def j(x, w):
        def body(c, _):
            if inner == 1:
                return c @ w, None
            return jax.lax.scan(lambda ci, _: (ci @ w, None), c, None, length=inner)[0], None
        return jax.lax.scan(body, x, None, length=outer)[0]

    def t(x, w):
        for _ in range(outer * inner):
            x = x @ w
        return x

    want = _ref(j, SDS, SDS)
    assert _port(t, *_mats()).flops == want.flops == outer * inner * DOT


def test_bytes_scale_with_the_loop():
    """4 and 8 tanh steps: each iteration writes one (64, 64) float32 in
    both; the reference's iteration also writes its s32 loop counter."""
    def j(n):
        return lambda x: jax.lax.scan(lambda c, _: (jnp.tanh(c), None), x, None,
                                      length=n)[0]

    def t(n):
        def f(x):
            for _ in range(n):
                x = torch.tanh(x)
            return x
        return f

    x = _mats(1)
    r4, r8 = _ref(j(4), SDS).bytes, _ref(j(8), SDS).bytes
    p4, p8 = _port(t(4), *x).bytes, _port(t(8), *x).bytes
    assert p8 > p4 and r8 > r4
    assert (p8 - p4) / 4 == (r8 - r4) / 4 - 4 == 4 * N * N


def test_remat_raises_flops():
    def j_loss(p, x):
        h = x
        for _ in range(3):
            h = jnp.tanh(h @ p)
        return jnp.sum(h)

    def t_loss(p, x):
        h = x
        for _ in range(3):
            h = torch.tanh(h @ p)
        return torch.sum(h)

    plain_ref = _ref(jax.grad(j_loss), SDS, SDS).flops
    remat_ref = _ref(jax.grad(jax.checkpoint(j_loss)), SDS, SDS).flops
    p, x = _mats()
    p.requires_grad_()

    def plain(p, x):
        torch.autograd.grad(t_loss(p, x), p)

    def remat(p, x):
        loss = torch.utils.checkpoint.checkpoint(t_loss, p, x, use_reentrant=False)
        torch.autograd.grad(loss, p)

    got_plain, got_remat = _port(plain, p, x).flops, _port(remat, p, x).flops
    assert got_plain == plain_ref == 8 * DOT
    assert remat_ref >= plain_ref and got_remat >= got_plain
    assert got_remat == got_plain + 3 * DOT


# --------------------------------------------------------------------------
# SMOKE cells against the reference's single-device compile
# --------------------------------------------------------------------------

SMOKE_CELLS = [(a, s) for a in ("qwen1.5-0.5b", "deepseek-v3-671b", "mamba2-130m",
                                "jamba-1.5-large-398b", "qwen2-vl-7b")
               for s in ("prefill_32k", "decode_32k", "train_4k")]

_REF_CHILD = textwrap.dedent("""
    import json, sys
    from functools import partial
    import jax, numpy as np
    from repro.launch.hlo_analysis import summarize
    from repro.configs import SMOKE_ARCHS, SMOKE_SHAPES
    from repro.models import init_cache, init_params
    from repro.serve.engine import make_decode_step, make_prefill
    from repro.train import OptConfig, make_train_step
    from repro.train.batching import input_specs
    from repro.train.optimizer import init_opt

    out = {}
    for arch, name in json.loads(sys.argv[1]):
        cfg, shape = SMOKE_ARCHS[arch], SMOKE_SHAPES[name]
        params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
        b = input_specs(cfg, shape)
        if shape.kind == "train":
            opt = jax.eval_shape(partial(init_opt, cfg.optimizer), params)
            low = jax.jit(make_train_step(cfg, OptConfig(name=cfg.optimizer), 1)).lower(
                params, opt, b, 0)
        else:
            cache = jax.eval_shape(partial(init_cache, cfg, shape.global_batch,
                                           shape.seq_len))
            if shape.kind == "prefill":
                low = jax.jit(make_prefill(cfg, shape.seq_len)).lower(params, b, cache)
            else:
                fn = make_decode_step(cfg)
                args = [params, cache, b["tokens"], jax.ShapeDtypeStruct((), np.int32)]
                if "positions3" in b:
                    low = jax.jit(lambda p, c, t, l, q: fn(p, c, t, l, positions3=q)).lower(
                        *args, b["positions3"])
                else:
                    low = jax.jit(fn).lower(*args)
        out[f"{arch}|{name}"] = summarize(low.compile().as_text()).flops
    print(json.dumps(out))
""")

_PORT_CHILD = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    out = {}
    for arch, name in json.loads(sys.argv[1]):
        rec = dryrun.run_cell(arch, name, "single", smoke=True, cost=True)
        out[f"{arch}|{name}"] = rec
    for mesh_kind in ("single", "multi"):
        out[f"acai|{mesh_kind}"] = dryrun.run_acai_cell(mesh_kind, cost=True)
    print(json.dumps(out))
""")


def _child(code: str, cells):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH="src", JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(cells)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def _collect(proc, timeout=300) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


# the cells the collective comparison runs, at (1, 2) and (2, 2): a training
# step (vocab-parallel loss at model 2), MLA + MoE decode, the jamba
# prefill, the retrieval step
COLL_CASES = [("qwen train", "qwen1.5-0.5b", "train_4k", {}),
              ("deepseek decode", "deepseek-v3-671b", "decode_32k", {}),
              ("jamba prefill", "jamba-1.5-large-398b", "prefill_32k", {}),
              ("acai", "acai", None, None)]
# ROADMAP C11: at model 4 a SMOKE qwen2-72b rank's one query head reads one
# of the two (whole) kv heads, a strided slice of the cache; flash forced
FLASH_CASE = ("qwen2-72b flash", "qwen2-72b", "prefill_32k",
              {"flash_threshold": 32, "flash_chunk": 16})
COLL_MESHES = [(1, 2), (2, 2)]
# ROADMAP C15: a SMOKE MoE prefill on world-less meshes of one and of two
# batch ranks
MOE_CASE = ("mixtral prefill", "mixtral-8x22b", "prefill_32k", {})
MOE_MESHES = [(1, 1), (2, 1)]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The reference's and the port's SMOKE counts (each in a process of its
    own: the port's cells open fake worlds) and the collective cases on
    gloo and fake worlds, all side by side."""
    tmp = tmp_path_factory.mktemp("cost")
    # the reference's compiles in three processes (jamba's training step
    # alone takes a third of them)
    ref_procs = [_child(_REF_CHILD, SMOKE_CELLS[i::3]) for i in range(3)]
    port_proc = _child(_PORT_CHILD, SMOKE_CELLS)
    jobs = {(shape, fake): (shape, fake, COLL_CASES)
            for shape in COLL_MESHES for fake in (False, True)}
    jobs[((1, 4), True)] = ((1, 4), True, [FLASH_CASE])
    for shape in MOE_MESHES:
        jobs[(shape, True)] = (shape, True, [MOE_CASE])
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {key: pool.submit(run_world, cost_rank, shape, tmp, cases, fake=fake)
                for key, (shape, fake, cases) in jobs.items()}
        worlds = {key: f.result() for key, f in futs.items()}
    want = {}
    for proc in ref_procs:
        want.update(_collect(proc))
    return {"ref": want, "port": _collect(port_proc), "worlds": worlds}


def ssd_decay_dots(cfg, shape) -> float:
    """The reference's SSD decay-gradient dots a training step (the
    module's docstring), summed over the Mamba2 layers."""
    if shape.kind != "train":
        return 0.0
    q = cfg.ssd_chunk
    c, h, p = shape.seq_len // q, cfg.ssm_heads, cfg.ssm_head_dim
    layers = sum(layer_kind(cfg, i)[0] == "mamba" for i in range(cfg.n_layers))
    return layers * 2.0 * shape.global_batch * c * q * h * (2 * p + q)


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS)
def test_smoke_flops_match_the_reference(cells, arch, shape):
    rec = cells["port"][f"{arch}|{shape}"]
    assert rec["status"] == "ok", rec.get("traceback")
    want = cells["ref"][f"{arch}|{shape}"]
    gap = ssd_decay_dots(SMOKE_ARCHS[arch], SMOKE_SHAPES[shape])
    assert rec["hlo"]["flops_per_device"] == want - gap
    assert (gap > 0) == (shape == "train_4k" and arch in ("mamba2-130m",
                                                           "jamba-1.5-large-398b"))
    assert rec["n_devices"] == 1 and rec["hlo"]["hbm_bytes_per_device"] > 0
    mem = rec["live_memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_peak_bytes"] > 0


@pytest.mark.parametrize("shape", COLL_MESHES)
@pytest.mark.parametrize("case", [c[0] for c in COLL_CASES])
def test_fake_world_counts_equal_the_gloo_worlds(cells, shape, case):
    """Rank 0 of a world-less mesh on meta tensors counts what rank 0 of a
    gloo world counts running the same step on the CPU: collective calls
    and bytes by class, and FLOPs."""
    gloo = cells["worlds"][(shape, False)]
    (fake,) = cells["worlds"][(shape, True)]
    got, want = fake[case], gloo[0][case]
    assert got["coll_counts"] == want["coll_counts"], case
    assert got["coll_bytes"] == want["coll_bytes"], case
    # the CPU's plain pairwise_l2 is one matmul, the meta call its kernel's
    # formula: the same 2 Q N D
    assert got["flops"] == want["flops"], case
    assert set(got["coll_counts"]) == set(COLLECTIVES)
    assert got["coll_counts"]["all-to-all"] == got["coll_counts"]["collective-permute"] == 0
    # every gloo rank counts the same pattern
    for r in gloo:
        assert r[case]["coll_counts"] == want["coll_counts"]


# --------------------------------------------------------------------------
# the production AÇAI cell by hand
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_acai_cell_against_a_hand_count(cells, mesh_kind):
    """The reference's cell (2^27 x 128 float32 over model 16, 4096 requests
    over the batch axes, c 64, k 10, top_a 4096): the local scan's 2 b n_s d
    FLOPs are the whole count (one `pairwise_l2` by its formula); the merge
    gathers the (b, c, 3) payload over `model`, the routing gather the (b,
    2c + k) rows over each batch axis (the second over pod carries the
    first's 16 rows), the projection the top_a + 1 heads; the metrics' two
    means reduce a float32 over each batch axis."""
    rec = cells["port"][f"acai|{mesh_kind}"]
    assert rec["status"] == "ok", rec.get("traceback")
    n_data = 32 if mesh_kind == "multi" else 16
    b, n_s, d, c, k, a = 4096 // n_data, 2 ** 27 // 16, 128, 64, 10, 4096
    h = rec["hlo"]
    assert h["flops_per_device"] == 2.0 * b * n_s * d
    assert rec["counted_ops"]["kernels"]["pairwise_l2"]["launches"] == 1
    assert rec["counted_ops"]["aten_dot_flops"] == 0
    route = 4 * b * (2 * c + k)
    gathers = [4 * b * c * 3, route, 4 * (a + 1)]
    reduces = [4, 4]
    if mesh_kind == "multi":
        gathers.append(16 * route)
        reduces *= 2
    assert h["collective_counts"] == {"all-reduce": len(reduces), "all-gather": len(gathers),
                                      "reduce-scatter": 0, "all-to-all": 0,
                                      "collective-permute": 0}
    assert h["collective_bytes_per_shard"]["all-gather"] == sum(gathers)
    assert h["collective_bytes_per_shard"]["all-reduce"] == sum(reduces)
    assert rec["collective_bytes_per_shard_total"] == sum(gathers) + sum(reduces)
    assert rec["n_devices"] == (512 if mesh_kind == "multi" else 256)
    assert rec["live_memory"]["argument_bytes"] == 4 * (n_s * d + n_s + 4096 * d)


# --------------------------------------------------------------------------
# the kernels' meta branches and formulas
# --------------------------------------------------------------------------

def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


I32, U8, BF = torch.int32, torch.uint8, torch.bfloat16
# (wrapper call on meta tensors, its plain version's call on CPU tensors of
# the same shapes, the outputs' shapes and dtypes, the kernel and its work)
META_CASES = {
    "pairwise_l2": (lambda t: ops.pairwise_l2(t(8, 16), t(100, 16)),
                    [((8, 100), torch.float32)],
                    [("pairwise_l2", W.pairwise_l2(8, 100, 16))]),
    "pairwise_l2_batched": (lambda t: ops.pairwise_l2_batched(t(2, 8, 16), t(2, 10, 16)),
                            [((8, 2, 10), torch.float32)],
                            [("pairwise_l2", W.pairwise_l2(8, 10, 16, 2))]),
    # past TOPK_SAMPLE_MIN_N rows the wrapper bounds the k-th distance by a
    # pairwise_l2 over the first TOPK_SAMPLE rows, on meta as on the card
    "topk_l2": (lambda t: ops.topk_l2(t(8, 16), t(200000, 16), 10),
                [((8, 10), torch.float32), ((8, 10), I32)],
                [("pairwise_l2", W.pairwise_l2(8, ops.TOPK_SAMPLE, 16)),
                 ("l2_topk", W.l2_topk(8, 200000, 16, 10))]),
    "topk_l2_fused": (lambda t: ops.topk_l2_fused(t(8, 16), t(2000, 16), 10, chunk=100),
                      [((8, 10), torch.float32), ((8, 10), I32)],
                      [("l2_topk", W.l2_topk(8, 2000, 16, 10))]),
    "ivf_scan_topk": (lambda t: ops.ivf_scan_topk(t(8, 16), t(2000, 16),
                                                  t(8, 64, dtype=I32), 10),
                      [((8, 10), torch.float32), ((8, 10), I32)],
                      [("ivf_scan", W.ivf_scan(8, 64, 16, 10))]),
    "ivf_scan_lists": (lambda t: ops.ivf_scan_lists(t(8, 16), t(2000, 16),
                                                    t(32, 40, dtype=I32),
                                                    t(8, 4, dtype=torch.int64), 10),
                       [((8, 10), torch.float32), ((8, 10), I32)],
                       [("ivf_scan_lists", W.ivf_scan_lists(8, 4, 40, 16, 10, nlist=32))]),
    "pq_adc": (lambda t: ops.pq_adc(t(8, 4, 256), t(100, 4, dtype=U8)),
               [((8, 100), torch.float32)],
               [("pq_adc", W.pq_adc(8, 100, 4, 256, ndistinct=100))]),
    "pq_adc_gather": (lambda t: ops.pq_adc_gather(t(8, 4, 256), t(100, 4, dtype=U8),
                                                  t(8, 30, dtype=I32)),
                      [((8, 30), torch.float32)],
                      [("pq_adc", W.pq_adc(8, 30, 4, 256))]),
    "pq_shortlist_lists": (lambda t: ops.pq_shortlist_lists(
        t(8, 4, 256), t(32, 40, 4, dtype=U8), t(32, 40, dtype=I32),
        t(8, 4, dtype=torch.int64), 64),
        [((8, 64), torch.float32), ((8, 64), I32)],
        [("pq_adc_lists", W.pq_adc_lists(
            8, 4, 40, 4, 64, c=256, nlist=32,
            width=4 * ops.pq_lists_plan(32, 40, 4, 64, 4, 256, 8)[0]
            * min(64, ops.pq_lists_plan(32, 40, 4, 64, 4, 256, 8)[1])))]),
    "flash_attention": (lambda t: ops.flash_attention(t(1, 64, 4, 64, dtype=BF),
                                                      t(1, 64, 2, 64, dtype=BF),
                                                      t(1, 64, 2, 64, dtype=BF)),
                        [((1, 64, 4, 64), BF)],
                        [("flash_attention_wgmma",
                          W.flash_attention(1, 64, 64, 4, 2, 64, 64, causal=True))]),
}


class _Kernels:
    def __init__(self):
        self.calls = []

    def add_kernel(self, kernel, work):
        self.calls.append((kernel, work))

    def add_collective(self, primitive, nbytes):
        pass


@pytest.mark.parametrize("name", list(META_CASES))
def test_meta_branch_returns_the_kernels_shapes_and_adds_its_work(name):
    call, outs, kernels = META_CASES[name]
    ops.reset_launches()
    rec = _Kernels()
    with W.open_record(rec):
        got = call(_m)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == outs
    assert all(t.is_meta for t in got)
    assert rec.calls == kernels
    assert sum(ops.LAUNCHES.values()) == 0     # a meta call launches nothing
    # CPU tensors of the same shapes: the plain version, no kernel's work
    g = torch.Generator().manual_seed(0)

    def cpu(*shape, dtype=torch.float32):
        if dtype in (torch.float32, BF):
            return torch.rand(shape, generator=g).to(dtype)
        # ids below 4 name a row, a list and a probe in every case
        return torch.randint(0, 256 if dtype == U8 else 4, shape, generator=g, dtype=dtype)

    rec = _Kernels()
    with W.open_record(rec):
        plain = call(cpu)
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert rec.calls == [] and sum(ops.LAUNCHES.values()) == 0
    assert [(tuple(t.shape), t.dtype) for t in plain] == outs


def test_flash_backward_on_meta_is_the_plain_recompute_counted_by_aten():
    """FlashAttentionFn on meta tensors: the forward adds the kernel's work
    (no launch); the backward is the plain chunked recompute, whose aten
    dots the mode counts as on the CPU."""
    def run(device):
        g = torch.Generator().manual_seed(0)
        qkv = [torch.rand(1, 64, 4, 16, generator=g).to(device).requires_grad_()
               for _ in range(3)]
        rec = _Kernels()
        with W.open_record(rec):
            out = ops.FlashAttentionFn.apply(*qkv, True, 0, 0, None, 16)
        with CostMode(qkv) as mode:
            grads = torch.autograd.grad(out.sum(), qkv)
        return rec.calls, mode.summary.aten_flops, [t.shape for t in grads]

    meta_calls, meta_flops, meta_shapes = run("meta")
    cpu_calls, cpu_flops, cpu_shapes = run("cpu")
    assert meta_calls == [("flash_attention", W.flash_attention(
        1, 64, 64, 4, 4, 16, 16, causal=True, itemsize=4))] and cpu_calls == []
    assert meta_flops == cpu_flops > 0 and meta_shapes == cpu_shapes


# PERF.md §6's table (the chip run it records): each row's shape, its data-dependent
# counts as printed, and the bound printed beside it, which the formulas
# then in scripts/kernel_shapes.py gave (nprobe 16 and nlist 256, the IVF
# indexes' settings)
TABLE = """\
pairwise_l2|Q=64 N=864 D=128|0.00021128023880597017
pairwise_l2|Q=64 N=256 D=128|6.847044776119403e-05
pairwise_l2|Q=64 N=256 D=16 M=8|0.00020541134328358208
pairwise_l2|Q=64 N=16384 D=128|0.004006499343283582
pairwise_l2|Q=8 N=864 D=128|0.00014152597014925372
pairwise_l2|Q=8 N=256 D=128|4.279402985074627e-05
pairwise_l2|Q=8 N=256 D=16 M=8|5.991164179104478e-05
pairwise_l2|Q=8 N=16384 D=128|0.002661788656716418
pairwise_l2|Q=8 N=1000000 D=128|0.1623892823880597
pairwise_l2|Q=512 N=16384 D=128|0.03205199474626866
pairwise_l2|Q=256 N=16384 D=128|0.01602599737313433
pairwise_l2|Q=1 N=1000000 D=1024|1.2238818197014925
pairwise_l2|Q=1 N=16384 D=1024|0.0200532823880597
pairwise_l2|Q=1 N=864 D=1024|0.0010586555223880596
pairwise_l2|Q=8 N=1000000 D=1024|1.2322485874626865
pairwise_l2|Q=8 N=16384 D=1024|0.02019878208955224
pairwise_l2|Q=8 N=864 D=1024|0.0010744358208955225
pairwise_l2|Q=512 N=16384 D=1024|0.25641595797014927
pairwise_l2|Q=64 N=1000000 D=128|0.2445373134328358
pairwise_l2|Q=8 N=250000 D=128|0.0405982376119403
pairwise_l2|Q=64 N=250000 D=128|0.06113432835820895
pairwise_l2|Q=8 N=500000 D=128|0.08119525253731344
pairwise_l2|Q=8 N=524288 D=128|0.08513933373134329
pairwise_l2|Q=500000 N=256 D=128|0.4890746268656716
pairwise_l2|Q=1 N=256 D=128|3.95844776119403e-05
l2_topk|Q=64 N=1000000 D=128 k=64|0.15285538388059702
l2_topk|Q=8 N=1000000 D=128 k=64|0.1528382662686567
l2_topk|Q=512 N=1000000 D=128 k=128|0.2647919191919192
l2_topk|Q=512 N=1000000 D=128 k=160|0.2647919191919192
l2_topk|Q=8 N=1000000 D=128 k=20|0.1528374256716418
l2_topk|Q=256 N=1000000 D=128 k=51|0.15290612537313433
l2_topk|Q=1 N=1000000 D=1024 k=16|1.2226878280597013
l2_topk|Q=8 N=1000000 D=1024 k=16|1.2226966543283582
l2_topk|Q=512 N=1000000 D=1024 k=51|2.1183353535353535
l2_topk|Q=8 N=250000 D=128 k=64|0.03821140059701493
l2_topk|Q=64 N=250000 D=128 k=64|0.038228518208955224
l2_topk|Q=8 N=500000 D=128 k=64|0.07642035582089553
l2_topk|Q=8 N=1000000 live=500000 D=128 k=64|0.07671886328358209
ivf_scan_lists|B=64 P=66272 valid=4003002 distinct=984452 D=128 k=64|0.15165608597014926
ivf_scan_lists|B=8 P=66272 valid=499088 distinct=393798 D=128 k=64|0.06065955104477612
ivf_scan|B=64 P=256 valid=16384 distinct=16236 D=128 k=64|0.002520568358208955
ivf_scan|B=8 P=256 valid=2048 distinct=2046 D=128 k=64|0.0003175928358208955
ivf_scan|B=8 P=66416 valid=499106 distinct=393809 D=128 k=64|0.060824988656716414
ivf_scan|B=64 P=66416 valid=4002880 distinct=984427 D=128 k=64|0.15555064358208953
ivf_scan|B=8 P=17664 valid=125507 distinct=99853 D=128 k=64|0.015432291343283581
ivf_scan|B=64 P=17664 valid=1003182 distinct=243462 D=128 k=64|0.03857912358208955
pq_adc_lists|B=64 nprobe=16 slots=984311 M=8 C=256 kk=256 partials=4096|0.00430993791044776
pq_adc_lists|B=8 nprobe=16 slots=410618 M=8 C=256 kk=256 partials=4096|0.0015691438805970149
pq_adc|B=64 P=65504 valid=4003765 distinct=984311 M=8 C=256|0.012518454925373134
pq_adc|B=8 P=65504 valid=500401 distinct=410618 M=8 C=256|0.0022515629850746273
flash|B=1 S=512 T=8192 H=16 KV=16 Dk=64 Dv=64 causal=1 window=0 wu=512|0.010642263880597014
flash|B=1 S=4096 T=8192 H=16 KV=16 Dk=64 Dv=64 causal=1 window=0 wu=4096|0.03475038116885743
flash|B=1 S=8000 T=8192 H=128 KV=128 Dk=192 Dv=128 causal=1 window=0 wu=8000|2.650927886754297
flash|B=1 S=8192 T=8192 H=48 KV=8 Dk=128 Dv=128 causal=1 window=4096 wu=8192|0.6254050781314459
flash|B=1 S=8024 T=8192 H=28 KV=4 Dk=128 Dv=128 causal=1 window=0 wu=8024|0.4666998552072801
flash|B=1 S=8192 T=8192 H=16 KV=16 Dk=80 Dv=80 causal=0 window=0 wu=8192|0.34741899259858444
flash|B=1 S=8192 T=8192 H=16 KV=16 Dk=64 Dv=64 causal=1 window=0 wu=8192|0.13898456085743174
flash|B=1 S=8192 T=10240 H=64 KV=8 Dk=128 Dv=128 causal=1 window=0 wu=8192|1.111876486859454
flash|B=1 S=8192 T=8192 H=16 KV=2 Dk=128 Dv=128 causal=1 window=0 wu=8192|0.2779691217148635
flash|B=1 S=8192 T=8192 H=32 KV=32 Dk=192 Dv=128 causal=1 window=0 wu=8192|0.6949228042871587
"""


def _work(kernel, f):
    if kernel == "pairwise_l2":
        return W.pairwise_l2(f["Q"], f["N"], f["D"], f.get("M", 1))
    if kernel == "l2_topk":
        live = f.get("live")
        return W.l2_topk(f["Q"], f["N"], f["D"], f["k"], live=live, masked=live is not None)
    if kernel == "ivf_scan":
        return W.ivf_scan(f["B"], f["P"], f["D"], f["k"], nvalid=f["valid"],
                          ndistinct=f["distinct"])
    if kernel == "ivf_scan_lists":
        return W.ivf_scan_lists(f["B"], 16, f["P"] // 16, f["D"], f["k"], nlist=256,
                                nvalid=f["valid"], ndistinct=f["distinct"])
    if kernel == "pq_adc_lists":
        # the bound is the bytes'; the valid slots' adds are far below it
        return W.pq_adc_lists(f["B"], f["nprobe"], 0, f["M"], f["kk"], c=f["C"], nlist=256,
                              width=f["partials"], slots=f["slots"], nvalid=f["slots"])
    if kernel == "pq_adc":
        return W.pq_adc(f["B"], f["P"], f["M"], f["C"], nvalid=f["valid"],
                        ndistinct=f["distinct"])
    return W.flash_attention(f["B"], f["S"], f["T"], f["H"], f["KV"], f["Dk"], f["Dv"],
                             causal=bool(f["causal"]), window=f["window"],
                             written_upto=f["wu"])


# the inline formulas scripts/kernel_shapes.py held before they moved into
# kernels/cost.py: (bytes, FLOPs, peak)
def _old(kernel, f):
    if kernel == "pairwise_l2":
        m, q, n, d = f.get("M", 1), f["Q"], f["N"], f["D"]
        return 4.0 * m * (q * d + n * d + q * n), 2.0 * m * q * n * d, 67e12
    if kernel == "l2_topk":
        rows = f.get("live", f["N"])
        return (4.0 * (rows * f["D"] + f["Q"] * f["D"]) + (f["N"] if "live" in f else 0)
                + 8.0 * f["Q"] * f["k"], 2.0 * f["Q"] * rows * f["D"], 495e12)
    if kernel == "ivf_scan":
        b, p, d, k = f["B"], f["P"], f["D"], f["k"]
        return 4.0 * (f["distinct"] * d + b * p + b * d) + 8.0 * b * k, 3.0 * f["valid"] * d, \
            67e12
    if kernel == "ivf_scan_lists":
        b, d, k = f["B"], f["D"], f["k"]
        return (4.0 * (f["distinct"] * (d + 1) + b * 16 + 256 + b * d) + 8.0 * b * k,
                3.0 * f["valid"] * d, 67e12)
    if kernel == "pq_adc_lists":
        b, m, c = f["B"], f["M"], f["C"]
        return (f["slots"] * (m + 4.0) + 4.0 * (b * f["nprobe"] + 256 + b * m * c)
                + 8.0 * b * f["partials"], float(f["slots"] * m), 67e12)
    if kernel == "pq_adc":
        b, p, m, c = f["B"], f["P"], f["M"], f["C"]
        return 8.0 * b * p + f["distinct"] * m + 4.0 * b * m * c, float(f["valid"] * m), 67e12
    b, s, t, h, kv, dk, dv = (f[x] for x in ("B", "S", "T", "H", "KV", "Dk", "Dv"))
    pairs = W.kept_pairs(b, s, t, bool(f["causal"]), f["window"], 0, f["wu"])
    return (2.0 * (b * s * h * (dk + dv) + b * t * kv * (dk + dv)), 2.0 * (dk + dv) * h * pairs,
            989e12)


@pytest.mark.parametrize("row", TABLE.splitlines())
def test_kernel_formulas_give_the_tables_bounds(row):
    kernel, shape, bound = row.split("|")
    f = {k: int(v) for k, v in (kv.split("=") for kv in shape.split())}
    ms, by = W.bound_ms(_work(kernel, f))
    nbytes, flops, peak = _old(kernel, f)
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / peak * 1e3
    assert (ms, by) == ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))
    assert ms == pytest.approx(float(bound), rel=1e-12)


@pytest.mark.parametrize("live", [248069, 207553])
def test_masked_formulas_equal_the_old_ones(live):
    """The churn rows whose tombstone bytes the table does not print: the
    masked IVF probe and IVF-PQ shortlist formulas against the old inline
    ones at the rows' counts and a stand-in probed-slot count."""
    b, k, d, cols, slots = 8, 64, 128, 4268, 3 * live
    work = W.ivf_scan_lists(b, 16, cols, d, k, nlist=256, nvalid=live, ndistinct=live - 7,
                            mask_bytes=slots)
    assert work.bytes == 4.0 * ((live - 7) * (d + 1) + b * 16 + 256 + b * d) + slots \
        + 8.0 * b * k
    assert work.flops == 3.0 * live * d
    work = W.pq_adc_lists(b, 16, cols, 8, 256, c=256, nlist=256, width=4096, slots=slots,
                          nvalid=live, masked=True)
    assert work.bytes == slots * 13.0 + 4.0 * (b * 16 + 256 + b * 8 * 256) + 8.0 * b * 4096
    assert work.flops == float(live * 8)


# --------------------------------------------------------------------------
# faults the production cells found
# --------------------------------------------------------------------------

def test_moe_expert_term_follows_the_rank_tokens(cells):
    """ROADMAP C15: SMOKE mixtral's prefill (2 x 64 tokens, 4 experts, top-2,
    dropless: cap(t) = 2 t) on a world-less (1, 1) mesh and on (2, 1).  On
    one batch rank the expert buffers are the unmeshed layer's, cap(128) =
    256 rows an expert; on two a rank's 64 tokens are part of the one
    block and take min(64, 256) = 64 rows (every rank ran 256 before).
    Every other dot halves with the rank's tokens, so the counts differ by
    exactly the expert term 2 x 3 matmuls x E x rows x d x f a MoE layer."""
    cfg, shape = SMOKE_ARCHS[MOE_CASE[1]], SMOKE_SHAPES[MOE_CASE[2]]
    t = shape.global_batch * shape.seq_len
    layers = sum(layer_kind(cfg, i)[1] == "moe" for i in range(cfg.n_layers))

    def expert(rows):
        return layers * 3 * 2.0 * cfg.n_experts * rows * cfg.d_model * cfg.moe_d_ff

    one, two = (cells["worlds"][(m, True)][0][MOE_CASE[0]]["flops"] for m in MOE_MESHES)
    assert cfg.capacity_factor <= 0 and layers > 0
    assert two == (one - expert(t * cfg.experts_per_token)) / 2 + expert(t // 2)
    assert two < one / 2


def test_flash_on_a_strided_kv_slice(cells):
    """ROADMAP C11: a rank whose query heads read some of the cache's (whole)
    kv heads hands flash a strided slice; the kernel takes whole rows, so
    qwen2-72b's prefill at model 16 raised on meta (and on the card).  The
    SMOKE form at (1, 4) with flash forced: the prefill runs and launches
    the kernel once a layer."""
    (res,) = cells["worlds"][((1, 4), True)]
    assert res["qwen2-72b flash"]["kernels"] == {"flash_attention": 2}


def test_projection_scale_and_mrope_on_meta():
    """ROADMAP C12: the water level's index and M-RoPE's section ids took a
    host read-back (`s_m[idx]` with a 0-d tensor, `repeat_interleave` with
    tensor counts); both now run on meta tensors, and on the CPU they give
    what they gave."""
    from repro_torch.core.projection import _negentropy_scale_from_sorted
    from repro_torch.models.layers import apply_mrope

    s, ok = _negentropy_scale_from_sorted(_m(32), _m(), 4.0)
    assert s.is_meta and s.shape == () and ok.dtype == torch.bool
    z = torch.sort(torch.rand(32, generator=torch.Generator().manual_seed(0)),
                   descending=True).values
    s, ok = _negentropy_scale_from_sorted(z, torch.tensor(3.0), 4.0)
    assert bool(ok) and float(torch.clamp_max(z * s, 1.0).sum() + 3.0 * s) == \
        pytest.approx(4.0, rel=1e-5)
    out = apply_mrope(_m(2, 8, 4, 16), _m(3, 2, 8, dtype=torch.int32), 10000.0, (2, 3, 3))
    assert out.is_meta and out.shape == (2, 8, 4, 16)
    x = torch.rand(2, 8, 4, 16, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(8).expand(3, 2, 8)
    got = apply_mrope(x, pos, 10000.0, (2, 3, 3))
    from repro_torch.models.layers import apply_rope
    torch.testing.assert_close(got, apply_rope(x, pos[0], 10000.0), rtol=1e-6, atol=1e-6)
