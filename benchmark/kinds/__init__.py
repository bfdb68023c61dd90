"""The kinds of traffic, one module each, found by the ``kind`` of a
traffic mix (``common.load_kind``)."""
