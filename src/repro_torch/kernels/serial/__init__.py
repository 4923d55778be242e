"""The one-thread device loops: the serialized RMW executor and the chase."""
