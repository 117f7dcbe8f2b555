"""Multi-process training: process-group start-up (``distributed``) and the data axis (``mesh``)."""
