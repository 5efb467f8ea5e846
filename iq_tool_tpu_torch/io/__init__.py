"""Host I/O: WAV/RF64 containers, raw files, SDR metadata parsing.

The reference delegates container I/O to libsndfile and XML to libexpat
(README.md:56-67); this package implements the needed subset natively in
Python (RIFF/RF64 with streaming header patch-on-close, auxi chunks,
SDR#-style filename metadata) so the framework has no native audio deps.
"""
