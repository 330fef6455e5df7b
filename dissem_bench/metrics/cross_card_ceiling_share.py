"""Goal bytes over ``ttd_s``, as a share of the cross-card ceiling the
set-up measured: the sum, over the (seeder card, dest card) pairs the
assignment moves blobs over, of a 1 GiB copy's rate on that pair alone
(cells whose seeders hold device copies on other cards)."""

from ..layout import model_nbytes
from . import mean


def read(run):
    ttd = mean(r["ttd_s"] for r in run.rounds)
    if not run.probe_gbps or not ttd:
        return None
    return model_nbytes(run.shape) / ttd / 1e9 / run.probe_gbps * 100
