"""Host-side data pipeline (numpy, the standard library and the native image
library; no device code). ``process`` is the raw-corpus ETL; it imports
OpenCV or PIL only when it reads or writes an image."""

from . import process  # noqa: F401
