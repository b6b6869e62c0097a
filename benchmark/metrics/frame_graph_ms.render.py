"""Device ms a frame of the frame graph (``prepare_frame`` at the pose):
the timing events the program records round each replay of a graph whose
key starts with ``"frame"``. Nothing is read where there are none (no
record, or no CUDA device)."""
from benchmark.spans import program_record, spans_of


def read(r):
    spans = [s for s in spans_of(program_record(), ("graph.replay",))
             if "device_ms" in s and isinstance(s["attr"], tuple)
             and s["attr"][:1] == ("frame",)]
    if not spans:
        return None
    return sum(s["device_ms"] for s in spans) / r["trace"]["units"]
