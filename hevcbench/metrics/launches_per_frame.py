"""launches_per_frame: kernel records on the card in the traced sub-window
over the frames coded in it (copies and memsets not counted)."""


def read(rec):
    if rec.trace is None or not rec.trace.frames:
        return None
    return len(rec.trace.kernels()) / rec.trace.frames
