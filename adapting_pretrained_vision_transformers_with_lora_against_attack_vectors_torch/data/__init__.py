"""Host-side data pipeline (numpy, pandas and PIL; no device code)."""
