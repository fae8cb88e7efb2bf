"""Command-line entry points: inference CLI, REPL, installer doctor."""
