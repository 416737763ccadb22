from .fastx import stream_fastx, read_fasta_lengths, open_text_maybe_gzip, FastxRecord, reverse_complement  # noqa: F401
