"""The plain reference the output check holds the program to: torch and
numpy only, nothing of the program."""
