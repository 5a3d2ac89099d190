"""reader_busy.eval: the share of the loader's reader threads' time spent
parsing (the program's `loader.parse` spans over `num_readers` times the
loop's recorded stretch, each span clipped to it), as %: near 100 the
parser sets the loader's pace."""

from portbench.spans import busy_share


def read(run):
    return busy_share(run, "loader.parse")
