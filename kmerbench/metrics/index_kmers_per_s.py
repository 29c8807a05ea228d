"""Index rows (k-mers or suffixes) of all jobs of the window over its seconds."""


def read(run):
    if run.unit != "job" or not run.unit_seconds or not run.rows_per_job:
        return None
    return run.rows_per_job * len(run.unit_seconds) / run.window_s
