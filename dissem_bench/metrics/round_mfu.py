"""The whole round's share of the cards' peaks: the least time of its
work (``yardstick.round_least_time``) over ``time_to_serve_s``."""

from ..yardstick import round_least_time
from . import mean


def read(run):
    tts = mean(r["time_to_serve_s"] for r in run.rounds)
    if not tts:
        return None
    least = round_least_time(run.shape, run.tokens, run.chips,
                             run.seeders_in_hbm)
    return least / tts * 100
