"""The LLM side: decoder layers, attention, and the serving API."""
