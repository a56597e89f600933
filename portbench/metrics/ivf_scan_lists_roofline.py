"""The IVF probe's share of its roofline, in %: the least time the H100 takes
for the work the traced steps' probes need (the frozen formula of
`portbench/cost.py`, counted from the lists each batch probes: its distinct
rows and its valid slots), over the `ivf_scan_lists` kernel's device time."""

import torch

from portbench import cost


def read(ctx):
    ivf = ctx.system.ivf
    if ctx.trace is None or ivf is None:
        return None
    t = sum(e - s for name, s, e in ctx.trace.device
            if ctx.trace.kernel_name(name) == "ivf_scan_lists") / 1e6
    if t <= 0:
        return None
    cents = ivf["centroids"].double()
    nlist, d = cents.shape
    lens = torch.as_tensor(ivf["lens"], dtype=torch.float64)
    k = ctx.system.cfg["c_remote"]
    bound = 0.0
    for rec in ctx.trace_records:
        q = torch.from_numpy(rec[4]).to(cents.device).double()
        dc = ((q[:, None, :] - cents[None]) ** 2).sum(2)
        probe = torch.argsort(dc, dim=1, stable=True)[:, :ivf["nprobe"]].cpu()
        nvalid = float(lens[probe].sum())
        ndistinct = float(lens[torch.unique(probe)].sum())
        w = cost.ivf_scan_lists(q.shape[0], ivf["nprobe"], d, k, nlist=nlist,
                                nvalid=nvalid, ndistinct=ndistinct)
        bound += cost.bound_s(w)[0]
    return 100.0 * bound / t
