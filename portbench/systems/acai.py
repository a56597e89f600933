"""The system under test: the port's AÇAI cache (`repro_torch.core.policy.
AcaiCache`) over a remote index, and the comparison of its steps with the
plain reference (`portbench/reference.py`).

The benchmark makes the inputs and hands the same to both sides: from the
configuration's data seed the catalog, the fetching cost c_f (the mean distance of a row's
`kth` nearest neighbour over a sample of rows, the paper's Sec. V-C), the
IVF's centroids and inverted lists (k-means by the benchmark, so that the
lists are the same on both sides: the program's own k-means sums with
atomics); from the run's seed DepRound's uniforms for the first cache
state and each step's rounding uniforms.

The comparison follows the program step by step from its own state: at the
steps that the seed picks, the reference takes the state the program held
before the step and the step's requests and uniforms, and works the step out
again.  The start is checked by itself (y_1 = h / N, x_1 by DepRound, and the
window's step 0 starts from them), and so is the rounding of each picked
step (from the program's own y_{t+1}).  A request at a near tie
(`reference.TIE_REL`) is left out of the serving comparison.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import reference, traffic

# a request's cost or gain differs where the two sides part by more than
# this share of k * c_f (float32 rounding of a k-term sum reads ~1e-7)
SERVE_TOL = 1e-5
# an object's y_{t+1} differs where the two sides part by more than this
# share of the reference's value (float32 rounding reads ~1e-6; the OMA
# step moves a touched object by up to exp(0.05) - 1)
Y_TOL = 1e-3


@dataclasses.dataclass
class Kept:
    """What a picked step fed the program and what it gave back."""
    step: int
    batch: int
    rs: np.ndarray
    y: torch.Tensor
    x: torch.Tensor
    u: torch.Tensor
    out: dict
    fetched: torch.Tensor
    occupancy: torch.Tensor
    y_new: torch.Tensor
    x_new: torch.Tensor


class System:
    def __init__(self, config: dict, seed: int, device):
        from repro_torch.core import oma, policy
        from repro_torch.index.base import IndexSpec

        t0 = time.perf_counter()
        self.device = torch.device(device)
        self.seed = seed
        a = config["acai"]
        self.data_seed = config["catalog"]["seed"]
        self.catalog = traffic.make_catalog(config["catalog"], self.device)
        self.catalog_host = self.catalog.cpu().numpy()
        n = self.catalog.shape[0]
        cf = config["c_f"]
        sample = torch.randperm(n, generator=traffic.generator(self.data_seed, traffic.SAMPLE,
                                                               self.device),
                                device=self.device)[:min(cf["sample"], n)]
        d, _, _ = reference.nearest(self.catalog[sample], self.catalog, cf["kth"] + 1)
        self.c_f = float(torch.mean(d[:, cf["kth"]]))
        self.cfg = {"h": a["h"], "k": a["k"], "c_f": self.c_f, "c_remote": a["c_remote"],
                    "c_local": a["c_local"], "eta": a["eta_times_cf"] / self.c_f}
        self.nag_scale = a["k"] * self.c_f
        ix = config["index"]
        self.ivf = None
        if ix["backend"] == "ivf":
            init = torch.randperm(n, generator=traffic.generator(self.data_seed,
                                                                 traffic.INIT, self.device),
                                  device=self.device)[:ix["nlist"]]
            cents, table = reference.kmeans_lists(self.catalog, ix["nlist"],
                                                  ix["train_iters"], init)
            self.ivf = {"centroids": cents, "nprobe": ix["nprobe"],
                        "invlists": torch.from_numpy(table.astype(np.int64)).to(self.device),
                        "lens": (table >= 0).sum(1)}
            spec = IndexSpec("ivf", {"nlist": ix["nlist"], "nprobe": ix["nprobe"],
                                     "centroids": cents.cpu().numpy(), "invlists": table})
        elif ix["backend"] == "flat":
            spec = IndexSpec("flat")
        else:
            raise ValueError(f"unknown index backend {ix['backend']!r}")
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        # the program from here on
        cfg = policy.AcaiConfig(h=a["h"], k=a["k"], c_f=self.c_f, c_remote=a["c_remote"],
                                c_local=a["c_local"], oma=oma.OMAConfig(eta=self.cfg["eta"]),
                                index=spec)
        self.u0 = torch.rand(n - 1, generator=traffic.generator(seed, traffic.UNIFORMS,
                                                                "cpu"))
        self.state0 = policy.init_state(n, cfg, seed=seed, device=self.device, u0=self.u0)
        self.cache = policy.AcaiCache(self.catalog, cfg, device=self.device,
                                      state=policy.copy_state(self.state0, seed))
        self.gen_u = traffic.generator(seed, traffic.UNIFORMS, self.device)
        self.kept: list[Kept] = []
        self.steps = 0
        self.diag = {}
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.phases = {"inputs_s": t1 - t0, "program_s": time.perf_counter() - t1}

    def warm(self, sizes) -> None:
        """One step at each batch size the traffic uses, then the first state
        again: the window starts from y_1, x_1."""
        from repro_torch.core.policy import copy_state

        gen = traffic.generator(self.seed, traffic.WARM, self.device)
        for b in sizes:
            rs = self.catalog_host[np.arange(b) % self.catalog_host.shape[0]]
            u = torch.rand(self.catalog.shape[0], generator=gen, device=self.device)
            m = self.cache.serve_update_batch(rs, u)
            m.gain_int.cpu()
        self.cache.state = copy_state(self.state0, self.seed)

    def serve(self, rs: np.ndarray, keep: bool = False) -> dict:
        """One step on a host batch: the program's serve and update, the
        batch's per-request results back on the host."""
        u = torch.rand(self.catalog.shape[0], generator=self.gen_u, device=self.device)
        before = self.cache.state
        m = self.cache.serve_update_batch(rs, u)
        out = {"gain": m.gain_int.cpu().numpy(), "cost": m.cost.cpu().numpy(),
               "served_local": m.served_local.cpu().numpy()}
        if keep:
            after = self.cache.state
            self.kept.append(Kept(self.steps, rs.shape[0], rs, before.y, before.x, u, out,
                                  m.fetched, m.occupancy, after.y, after.x))
        self.steps += 1
        return out

    def release(self) -> None:
        """Free the program's cache: what the check needs is kept."""
        self.cache = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """The numbers compared with their limits, from the program's outputs;
        with `control`, the same numbers from the reference in TF32 put in the
        program's place, as a second dict."""
        h = self.cfg["h"]
        n = self.catalog.shape[0]
        y0 = self.state0.y.cpu().numpy()
        x0 = self.state0.x.cpu().numpy()
        start = int((y0 != np.float32(h / n)).sum()) + int(
            (x0 != reference.depround(self.u0.numpy(), np.full(n, np.float32(h / n)))).sum())
        for s in self.kept:
            if s.step == 0:
                start += int((s.y != self.state0.y).sum()) + int((s.x != self.state0.x).sum())
        prog = {"start_mismatch": start, "round_mismatch": 0, "serve_mismatch": 0, "y_diff": 0}
        ctrl = dict(prog, start_mismatch=0)
        requests = touched = ties = 0
        diff_gaps = []
        tol = SERVE_TOL * self.nag_scale
        for s in self.kept:
            q = torch.from_numpy(s.rs).to(self.device)
            ref = reference.step(q, self.catalog, s.y, s.x, self.cfg, self.ivf, s.batch)
            touched += int((ref["g"] > 0).sum())
            ref_host = {k: ref[k].cpu().numpy()
                        for k in ("cost", "gain", "served_local", "rel_gap")}
            compared = ref_host["rel_gap"] >= reference.TIE_REL
            requests += s.batch
            ties += int((~compared).sum())

            def differs(out):
                return ((np.abs(out["cost"] - ref_host["cost"]) > tol)
                        | (np.abs(out["gain"] - ref_host["gain"]) > tol)
                        | (out["served_local"] != ref_host["served_local"]))

            def serve_mismatch(out):
                return int((differs(out) & compared).sum())

            diff_gaps += ref_host["rel_gap"][differs(s.out)].tolist()

            def y_diff(y_new):
                return int((torch.abs(y_new.double() - ref["y_new"])
                            > Y_TOL * ref["y_new"]).sum())

            x_expect = reference.coupled_rounding(s.u, s.x, s.y, s.y_new)
            moved = torch.clamp_min(x_expect - s.x, 0.0).sum()
            fetched = torch.zeros_like(s.fetched)
            fetched[-1] = moved
            prog["round_mismatch"] += int((x_expect != s.x_new).sum()) + int(
                (s.fetched != fetched).sum()) + int((s.occupancy != x_expect.sum()).sum())
            prog["serve_mismatch"] += serve_mismatch(s.out)
            prog["y_diff"] += y_diff(s.y_new)
            if control:
                c = reference.step(q, self.catalog, s.y, s.x, self.cfg, self.ivf, s.batch,
                                   precision="tf32")
                ctrl["serve_mismatch"] += serve_mismatch({k: c[k].cpu().numpy() for k in
                                                  ("cost", "gain", "served_local")})
                ctrl["y_diff"] += y_diff(c["y_new"].float())
        self.diag = {"requests": requests, "ties": ties,
                     "program_diff_rel_gaps": sorted(diff_gaps)}
        out = []
        for r in (prog, ctrl):
            out.append({"start_mismatch": r["start_mismatch"],
                        "round_mismatch": r["round_mismatch"],
                        "serve_mismatch": r["serve_mismatch"],
                        "y_diff_share": r["y_diff"] / max(touched, 1)})
        return out[0] if not control else (out[0], out[1])
