"""reader_busy.lstm_eval: the share of the native batcher's four reader
threads' time spent reading and parsing full-frame videos into the
batch's pinned block (the program's `loader.parse` spans over
`num_readers` times the loop's recorded stretch, each span clipped to
it), as %: near 100 the readers set the cell's pace, not the device."""

from portbench.spans import busy_share


def read(run):
    return busy_share(run, "loader.parse")
