"""What decides ``correct``: the outputs of the timed path against the
plain reference (``reference/``), and the control that has to fail the
same comparison.

The outputs of a run are ``index`` (host positions, the step that built
the index) and ``answers`` [(step, answer)]. Each step is judged by its
reference side, ``reference/steps/<op>.py``, found by name. Every number
compared is a count of wrong things with the limit 0: the comparison is
exact, as the configurations state ("exact", "order", "complete").

- ``index_bad_rows``: rows of the sorted index outside the SBA, too short,
  repeated or missing, and adjacent pairs out of order.
- ``answers_bad``: answers of the window (histograms with their totals,
  counts) that differ from the reference's. Over an index that failed its
  check every answer counts as wrong, since the groups are worked out over
  the verified order.
"""

from __future__ import annotations

import json

from . import catalog

LIMITS = {"index_bad_rows": 0, "answers_bad": 0}


def _key(step) -> str:
    return json.dumps(step, sort_keys=True)


def _answers(ix, steps, how: str, bits: int = 32) -> dict:
    """{step key: answer} of each distinct step, by its reference side's
    ``expected`` or ``control``."""
    out = {}
    for step in steps:
        key = _key(step)
        if key not in out:
            side = catalog.reference_step(step["op"])
            out[key] = side.expected(ix, step) if how == "expected" else side.control(ix, step, bits)
    return out


def judge(g, outputs: dict) -> dict:
    """{name: (value, limit)} for the outputs of one run over the genome
    ``g`` (the index step's reference ``genome`` of the records)."""
    pos, index_step = outputs["index"]
    errs, ix = catalog.reference_step(index_step["op"]).check(g, pos, index_step)
    checks = {"index_bad_rows": sum(v for k, v in errs.items() if k != "rows")}
    answers = outputs["answers"]
    if checks["index_bad_rows"]:
        checks["answers_bad"] = len(answers)
    else:
        want = _answers(ix, [step for step, _ in answers], "expected")
        checks["answers_bad"] = sum(
            not catalog.reference_step(step["op"]).matches(got, want[_key(step)])
            for step, got in answers)
    return {name: (value, LIMITS[name]) for name, value in checks.items()}


def passed(checks: dict) -> bool:
    return all(value <= limit for value, limit in checks.values())


def control_outputs(g, outputs: dict, timed_index: bool, bits: int = 32) -> dict:
    """The reference in the program's place with one stated guarantee
    broken: the index step's ``control`` (an index built in the window,
    ``timed_index``, is replaced), and over it the answers of each step's
    ``control`` (by ``bits``-bit fingerprint groups: breaks "exact"), or the
    reference's own where the index breaks "order"."""
    pos, index_step = outputs["index"]
    side = catalog.reference_step(index_step["op"])
    pos, exact_answers = side.control(g, pos, index_step, timed_index, bits)
    _, ix = side.check(g, pos, index_step)
    steps = [step for step, _ in outputs["answers"]]
    want = _answers(ix, steps, "expected" if exact_answers else "control", bits)
    return {"index": (pos, index_step), "answers": [(s, want[_key(s)]) for s in steps]}
