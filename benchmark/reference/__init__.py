"""Plain f32 references the benchmark holds the port's outputs against."""
