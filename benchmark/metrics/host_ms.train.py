"""Host ms a training step in the loop's own work (the program's own
record, each span's self time): the batch draw, the batch's copy into the
static inputs (``step.load``), the optimizer's count (``step.prepare``)
and, where they fall in the window, the log readback, a new segment and
an occupancy refresh (the last two and the log wait on the device). The
graph's launch (``graph.replay``) is left out: it blocks until the card
has run the step before. Nothing is read where the program records no
spans."""
from benchmark.spans import program_record, self_ms

LEAVES = ("stage1.draw", "stage2.draw", "step.load", "step.prepare",
          "stage1.log", "stage2.log", "stage1.segment", "stage1.occupancy")


def read(r):
    host = self_ms(program_record(), LEAVES)
    return None if host is None else host / r["trace"]["units"]
