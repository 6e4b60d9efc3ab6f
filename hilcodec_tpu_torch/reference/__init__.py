"""Plain references of the port's models, written from their published
descriptions (imports torch and math only, no module of the port)."""
