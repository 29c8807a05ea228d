"""Mean ms between ``on_round`` calls (the first from the start of the
sort), over every round of the window's sorts."""


from kmerbench.record import spans_of


def read(run):
    rounds = [t for s in spans_of(run, "sort", "job") for t in s.rounds]
    return sum(rounds) / len(rounds) * 1e3 if rounds else None
