"""Host-side native code of the port: the packed feature cache's row
gather (``fastbatch``)."""
