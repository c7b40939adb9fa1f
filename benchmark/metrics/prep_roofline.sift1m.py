"""A hint generation's share of its least time in cell sift1m.prep
(DevicePianoEngine.preprocessing): the user bytes of the rows its hints
name, read once, and the bytes of the state it leaves, written once, at
the card's HBM rate (pbench/bounds.py::prep_bound), over the mean of the
window's preps' preprocessing_time (the program's host clock, ending on a
synchronize)."""

from pbench.readers import prep_roofline as read  # noqa: F401
