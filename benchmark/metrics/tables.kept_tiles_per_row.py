"""``tables.kept_tiles_per_row``: kept tiles over row tiles, over every
truncation table the program built in the window (``tables.kept_tiles``,
``tables.row_tiles``)."""

from benchmark.metrics._program_trace import recorded


def read(trace):
    rec = recorded()
    if rec is None or not rec[1].get("tables.row_tiles"):
        return None
    return rec[1].get("tables.kept_tiles", 0) / rec[1]["tables.row_tiles"]
