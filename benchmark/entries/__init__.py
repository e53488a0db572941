"""One module per entry point of the port that a configuration can drive
(``"entry"`` in its file): how a call is made, and how its answers are
held against the plain reference."""
