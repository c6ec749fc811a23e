"""Launchers of the LM stack: batched serving (``serve``) and training
(``train``)."""
