// Dependency engine of the PyTorch port: an asynchronous scheduler with
// read/write dependency tracking per variable (the port's own copy of
// the reference package's native engine; ref:
// src/engine/threaded_engine.cc :: ThreadedEngine, naive_engine.cc,
// engine.h :: Engine::PushAsync/WaitForVar/WaitForAll).
//
// Role: torch orders the card's work on its streams; this engine gives
// the reference's ORDERING SEMANTICS to host-side work torch cannot see,
// the Python callbacks of custom operators first (mxnet_tpu_torch/
// engine.py, operator.py). It is built with g++ at first use
// (mxnet_tpu_torch/native.py :: load_engine_lib) and bound through
// ctypes by the C ABI at the end of this file.
//
// Model (the reference's ThreadedVar invariants):
//   - a var holds a queue of pending ops; reads may run concurrently,
//     a write waits for all prior reads/writes and blocks later ops
//   - an op runs when every var it touches has granted it access
//   - completion releases grants and may ready successor ops
//   - an op error marks every written var poisoned; waiting on a
//     poisoned var surfaces the error (once per wait)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace mxt {

using Callback = std::function<std::string()>;  // "" = ok, else error msg

struct Opr;

struct Var {
  uint64_t id;
  // queue entries: (op, is_write)
  std::deque<std::pair<Opr*, bool>> queue;
  int running_reads = 0;
  bool running_write = false;
  std::string poison;  // first error from an op that wrote this var
};

struct Opr {
  Callback fn;
  std::vector<Var*> reads;
  std::vector<Var*> writes;
  std::atomic<int> pending{0};  // grants still needed before dispatch
};

class Engine {
 public:
  explicit Engine(int num_workers, bool naive)
      : naive_(naive) {
    if (!naive_) {
      for (int i = 0; i < (num_workers < 1 ? 1 : num_workers); ++i)
        workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~Engine() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_ready_.notify_all();
    for (auto& w : workers_) w.join();
    for (auto& kv : vars_) delete kv.second;
  }

  uint64_t NewVar() {
    std::lock_guard<std::mutex> lk(mu_);
    uint64_t id = next_var_++;
    auto* v = new Var();
    v->id = id;
    vars_[id] = v;
    return id;
  }

  // returns false if the var has pending/running ops (caller retries or
  // leaks; the reference defers deletion via the engine itself)
  bool DeleteVar(uint64_t id) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = vars_.find(id);
    if (it == vars_.end()) return true;
    Var* v = it->second;
    if (!v->queue.empty() || v->running_reads || v->running_write)
      return false;
    vars_.erase(it);
    delete v;
    return true;
  }

  std::string Push(Callback fn, const std::vector<uint64_t>& read_ids,
                   const std::vector<uint64_t>& write_ids) {
    auto* op = new Opr();
    op->fn = std::move(fn);
    {
      std::lock_guard<std::mutex> lk(mu_);
      // resolve + validate EVERYTHING before touching any var queue, so
      // a bad op never leaves dangling queue entries
      std::unordered_set<uint64_t> seen;
      for (auto id : read_ids) {
        auto it = vars_.find(id);
        if (it == vars_.end()) { delete op; return "unknown read var"; }
        if (!seen.insert(id).second) continue;
        op->reads.push_back(it->second);
      }
      for (auto id : write_ids) {
        auto it = vars_.find(id);
        if (it == vars_.end()) { delete op; return "unknown write var"; }
        if (!seen.insert(id).second) {
          delete op;
          return "var is both read and write";
        }
        op->writes.push_back(it->second);
      }
      int npend = (int)op->reads.size() + (int)op->writes.size();
      op->pending.store(npend);
      inflight_++;
      if (npend == 0) {
        ready_.push_back(op);
      } else {
        // Enqueue may grant immediately; GrantFront pushes to ready_
        // itself when the last grant lands — no second push here
        for (Var* v : op->reads) Enqueue(v, op, false);
        for (Var* v : op->writes) Enqueue(v, op, true);
      }
    }
    cv_ready_.notify_one();
    if (naive_) DrainAll();
    return "";
  }

  std::string WaitForVar(uint64_t id) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = vars_.find(id);
    if (it == vars_.end()) return "unknown var";
    Var* v = it->second;
    cv_done_.wait(lk, [&] {
      return v->queue.empty() && !v->running_write && v->running_reads == 0;
    });
    std::string err = v->poison;
    v->poison.clear();  // rethrown once, like the reference
    return err;
  }

  void WaitForAll() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [&] { return inflight_ == 0; });
  }

 private:
  // under mu_: grant access if this op is at the eligible front
  void Enqueue(Var* v, Opr* op, bool is_write) {
    v->queue.emplace_back(op, is_write);
    GrantFront(v);
  }

  void GrantFront(Var* v) {
    // grant as many front entries as the read/write rules allow
    while (!v->queue.empty()) {
      auto [op, is_write] = v->queue.front();
      if (is_write) {
        if (v->running_reads > 0 || v->running_write) break;
        v->running_write = true;
      } else {
        if (v->running_write) break;
        v->running_reads++;
      }
      v->queue.pop_front();
      if (op->pending.fetch_sub(1) == 1) {
        ready_.push_back(op);
        cv_ready_.notify_one();
      }
      if (is_write) break;  // nothing runs alongside a write
    }
  }

  void Complete(Opr* op, const std::string& err) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!err.empty())
      for (Var* v : op->writes)
        if (v->poison.empty()) v->poison = err;
    for (Var* v : op->reads) {
      v->running_reads--;
      GrantFront(v);
    }
    for (Var* v : op->writes) {
      v->running_write = false;
      GrantFront(v);
    }
    inflight_--;
    delete op;
    cv_done_.notify_all();
  }

  void WorkerLoop() {
    while (true) {
      Opr* op = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_ready_.wait(lk, [&] { return stop_ || !ready_.empty(); });
        if (stop_ && ready_.empty()) return;
        op = ready_.front();
        ready_.pop_front();
      }
      std::string err;
      try {
        err = op->fn();
      } catch (const std::exception& e) {
        err = e.what();
      } catch (...) {
        err = "unknown C++ exception in engine op";
      }
      Complete(op, err);
    }
  }

  void DrainAll() {
    // naive mode: execute everything inline on the calling thread
    while (true) {
      Opr* op = nullptr;
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (ready_.empty()) return;
        op = ready_.front();
        ready_.pop_front();
      }
      std::string err;
      try {
        err = op->fn();
      } catch (const std::exception& e) {
        err = e.what();
      } catch (...) {
        err = "unknown C++ exception in engine op";
      }
      Complete(op, err);
    }
  }

  bool naive_;
  std::mutex mu_;
  std::condition_variable cv_ready_, cv_done_;
  std::deque<Opr*> ready_;
  std::unordered_map<uint64_t, Var*> vars_;
  uint64_t next_var_ = 1;
  int inflight_ = 0;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

}  // namespace mxt

// ------------------------------------------------------------------ C ABI
// The reference's MX* engine subset (ref: src/c_api/ :: API_BEGIN/
// API_END, thread-local last error), with the same signatures.

namespace {
thread_local std::string mx_last_error;

int Fail(const std::string& msg) {
  mx_last_error = msg;
  return -1;
}
}  // namespace

extern "C" {

const char* MXGetLastError() { return mx_last_error.c_str(); }

int MXGetVersion(int* out) {
  *out = 20000;  // the reference package's version, 2.0.0
  return 0;
}

void* MXEngineCreate(int num_workers, int naive) {
  return new mxt::Engine(num_workers, naive != 0);
}

void MXEngineFree(void* h) { delete static_cast<mxt::Engine*>(h); }

uint64_t MXEngineNewVar(void* h) {
  return static_cast<mxt::Engine*>(h)->NewVar();
}

int MXEngineDeleteVar(void* h, uint64_t var) {
  return static_cast<mxt::Engine*>(h)->DeleteVar(var) ? 0 : 1;
}

// callback: int fn(void* ctx, char* err_out, int err_cap) ->
//   0 ok / nonzero error; on error the callback may write a
//   NUL-terminated message into err_out (it becomes the poison text
//   rethrown at wait)
typedef int (*MXEngineFnPtr)(void* ctx, char* err_out, int err_cap);

int MXEnginePushAsync(void* h, MXEngineFnPtr fn, void* ctx,
                      const uint64_t* reads, int n_reads,
                      const uint64_t* writes, int n_writes) {
  std::vector<uint64_t> r(reads, reads + n_reads);
  std::vector<uint64_t> w(writes, writes + n_writes);
  auto cb = [fn, ctx]() -> std::string {
    char buf[1024];
    std::memset(buf, 0, sizeof(buf));  // callback may omit the NUL
    int rc = fn(ctx, buf, (int)sizeof(buf));
    buf[sizeof(buf) - 1] = '\0';
    if (rc == 0) return std::string();
    return buf[0] ? std::string(buf)
                  : "engine op failed with code " + std::to_string(rc);
  };
  std::string err = static_cast<mxt::Engine*>(h)->Push(
      std::move(cb), r, w);
  if (!err.empty()) return Fail(err);
  return 0;
}

int MXEngineWaitForVar(void* h, uint64_t var) {
  std::string err = static_cast<mxt::Engine*>(h)->WaitForVar(var);
  if (!err.empty()) return Fail(err);
  return 0;
}

int MXEngineWaitForAll(void* h) {
  static_cast<mxt::Engine*>(h)->WaitForAll();
  return 0;
}

}  // extern "C"
