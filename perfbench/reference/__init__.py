"""Plain references of the benchmark's pipelines; they import nothing of
the program under test."""
