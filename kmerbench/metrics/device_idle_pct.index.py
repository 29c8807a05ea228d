"""Share of the traced window of an index-building cell in which no
operation ran on the device, %."""

from kmerbench.record import idle_pct


def read(run):
    return idle_pct(run) if run.unit == "job" else None
