"""The prover: commitments, prove(), FRI, the transcript and the proof's JSON form."""
