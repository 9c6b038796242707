"""pipeline.noise_ms: host ms per scan dispatch of the noise draw into the
static buffers (``pipeline.noise`` inside ``pipeline.dispatch``), over the
dispatches of the traced stretch; from the program's spans."""
from ranbench.harness import program_trace


def read(cell, out):
    pt = program_trace.load(cell, out)
    if pt is None:
        return None
    return program_trace.ms_per(pt, ("pipeline.noise",),
                                ("pipeline.dispatch",))
