"""Share of the traced generation window in which no device operation ran."""
from benchmark.core.readers import idle_share


def read(run):
    return idle_share(run)
