"""The benchmark's plain reference: numpy only, no code of the program."""
