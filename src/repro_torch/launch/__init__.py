"""Step builders and the serving loop (counterparts of
``repro/launch/steps.py`` and ``repro/launch/serve.py``)."""
