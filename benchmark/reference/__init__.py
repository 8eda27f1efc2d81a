"""The plain references: one module per system kind (its H, float64) and one
per traffic's algorithm (its plain float64 form, named by the traffic's
``reference`` key)."""
