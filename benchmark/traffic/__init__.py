"""The traffic generator and its mixes (``<mix>.json``)."""
