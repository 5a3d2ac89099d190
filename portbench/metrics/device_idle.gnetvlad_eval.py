"""device_idle.gnetvlad_eval: 1 - the union of the device's busy intervals
over the traced stretch's wall time, as %."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
