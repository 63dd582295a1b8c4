"""The port's analytic roofline for ranking stencil plans (reference:
``roofline/stencil.py``, ``roofline/calibrate.py``), priced for an H100.
"""
