"""Host ms a frame in the frame path's own work (the program's own record,
each span's self time): the pose's load (``render.pose``), the queued
copies to the host (``render.readback``), the copies out of the pinned
buffers (``render.host_copy``) and ``finish()`` (``render.finish``). The
graphs' launches and the wait on the device are left out. Nothing is
read where the program records no frames."""
from benchmark.spans import program_record, self_ms

SPANS = ("render.pose", "render.readback", "render.host_copy",
         "render.finish")


def read(r):
    host = self_ms(program_record(), SPANS)
    return None if host is None else host / r["trace"]["units"]
