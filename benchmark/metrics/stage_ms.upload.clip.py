"""Device ms a clip job spends in the program's span `tsnet.clip.upload`:
the sources' images, one-hot labels and boxes, and the driving clip's,
to the device (layer: clip I/O)."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_unit_ms(rec, program_spans.registry(),
                                     ["tsnet.clip.upload"], "tsnet.clip.run",
                                     "clip_shape")
