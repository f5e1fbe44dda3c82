"""straggler_pct.cards (program_counter): of the shards' chunk slots in the
traced calls, the share in which a shard had already finished while another
still ran: 100 ``shard.idle_steps`` / (``shard.steps`` +
``shard.idle_steps``), the program's counters over the traced calls. None
without a trace or where the program keeps neither counter."""

SOURCE = "program_counter"


def read(rec):
    t = rec.trace
    if t is None:
        return None
    c = t["counters"]
    steps, idle = c.get("shard.steps", 0), c.get("shard.idle_steps", 0)
    if steps + idle <= 0:
        return None
    return 100.0 * idle / (steps + idle)
