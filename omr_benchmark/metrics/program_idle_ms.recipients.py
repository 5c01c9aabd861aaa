"""Card-idle ms a message inside the program's spans of a message
(``detect``, ``encode.index``, ``encode.payload``, ``decode``): the idle
time that the program's host code leaves while it serves every recipient
(device trace against the program's spans)."""

from omr_benchmark import program_spans


def read(run):
    return program_spans.idle_ms(run, ["detect", "encode.index", "encode.payload", "decode"])
