"""Host ms a board inside the program's ``decode.solve`` span: the
recipient's k x k solve mod p (native library)."""

from omr_benchmark import program_spans


def read(run):
    return program_spans.host_ms(run, ["decode.solve"])
