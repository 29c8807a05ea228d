"""Device-idle ms a call while the host was inside one of the program's
``gk:`` spans: the traced window's idle intervals within those ranges."""

from kmerbench.program_spans import span_idle_ms


def read(run):
    return span_idle_ms(run, "call")
