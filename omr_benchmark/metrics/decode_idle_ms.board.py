"""Card-idle ms a board inside the program's ``decode`` span (the
recipient's ``Retriever.decode_digest``), the mean over the cards (device
trace against the program's spans)."""

from omr_benchmark import program_spans


def read(run):
    return program_spans.idle_ms(run, ["decode"])
