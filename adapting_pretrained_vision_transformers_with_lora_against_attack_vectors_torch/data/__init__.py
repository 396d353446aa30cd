"""Host-side data pipeline (numpy, the standard library and the native image
library; no device code)."""
