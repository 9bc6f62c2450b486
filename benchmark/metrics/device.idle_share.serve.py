"""device.idle_share.serve: the share (%) of the profiled sub-window of a
serving cell in which no kernel, copy or memset ran on the card. Moves
dets_per_s."""


def read(tr, driver):
    if tr.busy_s is None or not tr.window_s:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s / tr.window_s)
