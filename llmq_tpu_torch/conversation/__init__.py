"""Conversation service of the port: the state manager and its stores."""
