/*
 * mxtpu_c_api.h - flat C ABI for the mxnet_tpu_torch port.
 *
 * Counterpart of src/mxtpu_c_api.h (reference: include/mxnet/c_api.h and
 * c_predict_api.h): the same contract, over the PyTorch port.
 * libmxtpu.so embeds CPython: a pure C (or C++, Java, Go ...) program
 * links this library, calls MXTPUInit(), and drives NDArrays, operators,
 * autograd, KVStore and the predictor with no Python code of its own.
 *
 * Conventions (as in the reference):
 *   - every call returns 0 on success, -1 on failure;
 *   - MXGetLastError() returns the failure message for this thread's
 *     most recent failing call;
 *   - handles are opaque; free NDArrays with MXNDArrayFree.
 *
 * The embedded interpreter resolves the mxnet_tpu_torch package through
 * PYTHONPATH (set it to the repo root when embedding).  Arrays live on the
 * card (gpu(0)) unless MXTPU_C_API_CONTEXT names another context
 * ("cpu", "gpu(1)"); a predictor runs where dev_type (1 cpu, 2 gpu) and
 * dev_id put it.
 */
#ifndef MXTPU_C_API_H_
#define MXTPU_C_API_H_

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void *NDArrayHandle;
typedef int KVStoreHandle;

/* Boot (or attach to) the Python runtime and import mxnet_tpu_torch. */
int MXTPUInit(void);
/* Shut down the embedded interpreter (no-op when attached). */
int MXTPUShutdown(void);
const char *MXGetLastError(void);

/* -- NDArray ---------------------------------------------------------- */
/* dtype is a numpy dtype name: "float32", "int32", ... */
int MXNDArrayCreate(const void *data, size_t nbytes, const int64_t *shape,
                    int ndim, const char *dtype, NDArrayHandle *out);
int MXNDArrayFree(NDArrayHandle h);
int MXNDArrayGetShape(NDArrayHandle h, int *ndim, int64_t shape[8]);
int MXNDArrayGetDType(NDArrayHandle h, char dtype[16]);
/* Blocking copy device -> caller buffer (nbytes must match). */
int MXNDArraySyncCopyToCPU(NDArrayHandle h, void *out, size_t nbytes);
int MXNDArraySize(NDArrayHandle h, size_t *nbytes);

/* -- Operators --------------------------------------------------------- */
/* Invoke a registered operator by name.  Params are string key/value
 * pairs (values parsed like the reference's typed param dict).  On entry
 * *n_out is the capacity of outputs[]; on return it is the actual count. */
int MXImperativeInvoke(const char *op_name, NDArrayHandle *inputs,
                       int n_inputs, const char **param_keys,
                       const char **param_vals, int n_params,
                       NDArrayHandle *outputs, int *n_out);
int MXListAllOpNames(int *count, const char ***names);

/* -- Autograd ---------------------------------------------------------- */
int MXAutogradAttachGrad(NDArrayHandle h);
int MXAutogradRecordStart(void);
int MXAutogradRecordStop(void);
int MXAutogradBackward(NDArrayHandle loss);
int MXNDArrayGetGrad(NDArrayHandle h, NDArrayHandle *out);

/* -- Predictor (reference: include/mxnet/c_predict_api.h) -------------- */
/* Deploy-format inference: symbol.json text + .params bytes in, float32
 * tensors in/out.  The amalgamation/mobile predict surface. */
typedef void *PredictorHandle;
int MXPredCreate(const char *symbol_json_str, const void *param_bytes,
                 size_t param_size, int dev_type, int dev_id,
                 uint32_t num_input_nodes, const char **input_keys,
                 PredictorHandle *out);
int MXPredSetInput(PredictorHandle h, const char *key, const float *data,
                   const int64_t *shape, int ndim);
int MXPredForward(PredictorHandle h);
int MXPredGetOutputShape(PredictorHandle h, uint32_t index, int *ndim,
                         int64_t shape[8]);
int MXPredGetOutput(PredictorHandle h, uint32_t index, float *data,
                    size_t n_floats);
int MXPredFree(PredictorHandle h);

/* -- KVStore ----------------------------------------------------------- */
int MXKVStoreCreate(const char *type, KVStoreHandle *out);
int MXKVStoreInit(KVStoreHandle kv, int key, NDArrayHandle v);
int MXKVStorePush(KVStoreHandle kv, int key, NDArrayHandle v);
int MXKVStorePull(KVStoreHandle kv, int key, NDArrayHandle *out);
int MXKVStoreFree(KVStoreHandle kv);

#ifdef __cplusplus
}
#endif

#endif /* MXTPU_C_API_H_ */
