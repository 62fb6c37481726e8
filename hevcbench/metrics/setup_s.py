"""setup_s: process start to the first timed call (s): the library built or
loaded, the frame pool made, what the mix codes in set-up, and warm-up."""


def read(rec):
    return rec.setup_s
