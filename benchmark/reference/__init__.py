"""The plain reference the benchmark's comparison holds the program to."""
