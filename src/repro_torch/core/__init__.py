"""Specs, layouts, the resident-sweep API and timing."""
