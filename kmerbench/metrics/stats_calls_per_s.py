"""Statistics calls completed in the window over its seconds."""


def read(run):
    if run.unit != "call" or not run.unit_seconds:
        return None
    return len(run.unit_seconds) / run.window_s
