"""Card-idle ms a board inside the program's digest encoder spans
(``encode.index``, ``encode.payload``), the mean over the cards (device
trace against the program's spans)."""

from omr_benchmark import program_spans


def read(run):
    return program_spans.idle_ms(run, ["encode.index", "encode.payload"])
