"""decode_busy.gnetvlad_eval: the share of the native batcher's team's time
spent reading full-frame records and decoding them into the batch's
pinned block (the program's `loader.decode` spans over the team's threads
times the loop's recorded stretch, each span clipped to it), as %: near
100 the team sets the cell's pace, where `reader_busy` near 100 says the
record streams do."""

from portbench.team_spans import team_busy_share


def read(run):
    return team_busy_share("loader.decode")
