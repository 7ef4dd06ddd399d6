"""The plain reference aligner the benchmark judges SAM records by
(see aligner.py)."""
