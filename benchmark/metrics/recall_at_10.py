"""recall_at_10 (host_clock: taken by the benchmark from the answers, not
from the program): over every query answered in the window, the share of
its true top-10 (the reference's, ties in fp64 included) that the answer
holds (``judge.py``)."""

SOURCE = "host_clock"


def read(rec):
    return rec.judged["recall_at_10"] if rec.judged["answers"] else None
