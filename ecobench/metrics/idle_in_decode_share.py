"""Device idle inside the program's ``repro_torch.run.decode`` ranges over
the profiled sub-window (%)."""
from ecobench.harness import program


def read(run):
    return program.idle_in_decode_share(run.trace)
