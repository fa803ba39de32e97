"""The plain float32 reference that decides whether a run is correct."""
