"""Global constants (counterpart of ``uuo_mocap_tpu/settings.py``)."""

# Marker center sits 9.5 mm off the body surface (SOMA convention).
MARKER_DISTANCE = 0.0095
