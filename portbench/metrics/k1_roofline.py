"""K1's share of its roofline over the window's searches: the least time of
every search (portbench.roofline.k1_search_bound_s: the three bf16 products
of ``high`` at the bf16 peak, or its inputs read once at the HBM rate)
over the device time of K1's kernels, its split passes included."""

from portbench import arch
from portbench.roofline import k1_search_bound_s
from portbench.traffic import SPLITS

KERNELS = ("scores_split_kernel", "split_bf16_kernel")


def read(rec):
    if not rec.device_events:
        return None
    busy = sum(b - a for name, a, b in rec.device_events if any(k in name for k in KERNELS)) / 1e9
    if not busy:
        return None
    dim = arch.of(rec.cell.config).embed_dim(rec.cell.config)
    bound = 0.0
    for det in rec.detections:
        n_db = len(det.splits["train"])
        bound += 2 * sum(k1_search_bound_s(len(det.splits[s]), n_db, dim) for s in SPLITS)
    return 100.0 * bound / busy
