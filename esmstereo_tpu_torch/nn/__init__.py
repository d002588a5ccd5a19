"""Building blocks: convs, BatchNorm units, ShuffleMixer, init rules."""
