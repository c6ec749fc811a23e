"""Launchers of the LM stack: batched serving (``serve``)."""
