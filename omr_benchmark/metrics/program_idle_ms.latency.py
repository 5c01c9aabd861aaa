"""Card-idle ms a board inside the program's spans of a board (``detect``,
``encode.index``, ``encode.payload``, ``decode``): the idle time that the
program's host code leaves, against the rest that lies between its calls
(device trace against the program's spans)."""

from omr_benchmark import program_spans


def read(run):
    return program_spans.idle_ms(run, ["detect", "encode.index", "encode.payload", "decode"])
