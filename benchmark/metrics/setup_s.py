"""setup_s (host_clock): from the process' start (the first line of
``run.py``) to the window's start: imports, kernel builds, the corpus, the
index and the warm-up calls."""

SOURCE = "host_clock"


def read(rec):
    return rec.setup_s
