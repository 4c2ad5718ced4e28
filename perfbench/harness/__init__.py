"""The benchmark's harness: it reads BENCHMARK.json and the files the
cells name, drives the program, reads the trace and judges the outputs."""
