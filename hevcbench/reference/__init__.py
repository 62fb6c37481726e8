"""The plain reference that decides a run's ``correct``: H.265 arithmetic
from the standard (``ops``) and the encoder built on it (``encoder``).
Nothing here imports the measured program."""
