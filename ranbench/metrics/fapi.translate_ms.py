"""fapi.translate_ms: host ms of one slot's SCF → processor-request
translation (``scf.dl_tti_to_processor_request`` or
``scf.ul_tti_to_processor_request``), the mean over the window's slots; from
the benchmark's span."""


def read(cell, out):
    return out.spans.mean_ms("ranbench.translate")
