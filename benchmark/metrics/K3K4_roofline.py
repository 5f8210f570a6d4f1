"""K3 and K4, the edge-residual loss and its gradient over the solve's
packed observations (`edge_fwd_kernel`, `edge_loss_sum`, `edge_bwd_kernel`,
`edge_dm_sum`), against their bytes bound at 3.35 TB/s: 80% of the
iterations on the bf16 pack, the rest on the fp32 one."""
from benchmark.counts.work import roofline_share

UNIT = "%"
NAMES = {"edge_fwd_kernel", "edge_loss_sum", "edge_bwd_kernel", "edge_dm_sum"}


def read(run, suffix):
    return roofline_share(run, NAMES, "k3k4_bound_s")
