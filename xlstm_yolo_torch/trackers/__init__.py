"""Multi-object tracking on the host: ByteTrack, BoT-SORT (camera motion
in numpy by default) and their wiring to the predictor's ``Results``."""
from .bot_sort import BOTSORT  # noqa: F401
from .byte_tracker import BYTETracker  # noqa: F401
from .track import create_tracker, track_results  # noqa: F401
