"""Seconds from the process's start to the first unit's start (host clock):
torch and the card, the gauge input, the program's set-up, the warm-up."""


def read(run):
    return run["setup_s"]
