"""Ms a clip job in which the device runs nothing while the program's
`tsnet.clip.upload` or `tsnet.clip.copy_back` span is open on the host,
from the traced stretch's events (layer: clip I/O)."""

from benchmark import program_spans


def read(rec):
    return program_spans.idle_in_spans_ms(rec)
