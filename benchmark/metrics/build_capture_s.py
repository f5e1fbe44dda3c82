"""build_capture_s (program_counter): the seconds the build's CUDA graph
captures took per chunk, the mean over the window's chunks (``capture_s``
of the index's ``_round_stats``, read after each ``parallel_insert`` call,
which overwrites it). A capture is a host pass with the device idle."""

SOURCE = "program_counter"


def read(rec):
    got = [i["capture_s"] for i in rec.infos if i and "capture_s" in i]
    return sum(got) / len(got) if got else None
