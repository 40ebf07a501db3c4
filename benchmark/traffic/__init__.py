"""The benchmark's traffic generator (``generate.py``), read by every mix."""
